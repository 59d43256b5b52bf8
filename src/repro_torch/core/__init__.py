"""Core contribution: online auto-tuning at the code-generation level.

Public names of the ported core (those of ``repro.core``), resolved
lazily from their modules.
"""

import importlib

_EXPORTS = {
    "OnlineAutotuner": "autotuner",
    "AsyncGenerator": "compile_farm",
    "CompileFarm": "compile_farm",
    "DEFAULT_ENTRY_BYTES": "compilette",
    "Compilette": "compilette",
    "GeneratedKernel": "compilette",
    "GenerationCache": "compilette",
    "GenerationTicket": "compilette",
    "device_free_memory_bytes": "compilette",
    "executable_bytes": "compilette",
    "LatencyHeadroomGate": "decision",
    "LatencyHistogram": "decision",
    "RegenerationPolicy": "decision",
    "TuningAccounts": "decision",
    "Evaluator": "evaluator",
    "Measurement": "evaluator",
    "SimulatedEvaluator": "evaluator",
    "VirtualClock": "evaluator",
    "VirtualClockEvaluator": "evaluator",
    "filtered_training_time": "evaluator",
    "mean_real_time": "evaluator",
    "virtual_compilette": "evaluator",
    "virtual_kernel": "evaluator",
    "CostModelSearch": "explorer",
    "GreedyNeighborhood": "explorer",
    "RandomSearch": "explorer",
    "SearchStrategy": "explorer",
    "TwoPhaseExplorer": "explorer",
    "available_strategies": "explorer",
    "make_strategy": "explorer",
    "point_stripe": "explorer",
    "register_strategy": "explorer",
    "strategy_accepts": "explorer",
    "GATE_MODES": "gate",
    "FleetBus": "persistence",
    "LocalBackend": "persistence",
    "RegistryBackend": "persistence",
    "SharedFileBackend": "persistence",
    "TunedRegistry": "persistence",
    "compiler_version": "persistence",
    "device_fallbacks": "persistence",
    "device_fingerprint": "persistence",
    "merge_snapshots": "persistence",
    "VariantGate": "gate",
    "ALL_PROFILES": "profiles",
    "EQUIVALENT_PAIRS": "profiles",
    "TPU_V5E": "profiles",
    "DeviceProfile": "profiles",
    "device_smem_kb": "profiles",
    "scaled_profile": "profiles",
    "static_autotune": "static_tuner",
    "DeviceTraits": "transfer",
    "TransferSeed": "transfer",
    "device_traits": "transfer",
    "similarity": "transfer",
    "transfer_seeds": "transfer",
    "Param": "tuning_space",
    "Point": "tuning_space",
    "TuningSpace": "tuning_space",
    "clamped_options": "tuning_space",
    "product_space": "tuning_space",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}")
    return getattr(importlib.import_module(f"repro_torch.core.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
