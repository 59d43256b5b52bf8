"""Kernel catalog: the kernel-granular tuning plane's registry.

Mirrors ``repro/kernels/catalog.py``. Every op module under
``repro_torch/kernels/*/ops.py`` exposes a declarative :class:`KernelDef`;
the process-wide :class:`KernelCatalog` discovers them and builds
:class:`KernelCompilette`\\ s — generators that know how to extract their
tuning *spec* (the run-time constants: problem shape, dtype, device) from
live call arguments, how to produce the variant for a point, and how to
price themselves on a simulated device profile for deterministic
virtual-clock tests.

Where the JAX catalog AOT-compiles each variant, here ``_build`` asks the
kernel's ``generate`` for it: on a CUDA device that resolves the point's
instantiation in a library built once (CUDA C++) or compiles the point's
binary (Triton), so the real generation cost lands in
``generation_time_s``. A failure to build or launch raises; nothing falls
back to a plain version. A kernel whose variants compile at run time
(Triton's lintra) can have that compile run in a child process by the
compile farm's ``"process"`` backend (:meth:`KernelCompilette.process_payload`,
:func:`compile_in_process`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import os
import time
from typing import Any, Callable, Mapping

import torch

from repro_torch.core.compilette import Compilette
from repro_torch.core.profiles import TPU_V5E, DeviceProfile, device_smem_kb
from repro_torch.core.tuning_space import Point, TuningSpace
from repro_torch.interop import resolve_device

__all__ = [
    "KernelDef",
    "KernelCompilette",
    "KernelCatalog",
    "compile_in_process",
    "discover_kernels",
    "example_fill",
    "get_catalog",
    "spec_capacity_kb",
    "spec_on_cuda",
    "torch_dtype",
]


def example_fill(shape: tuple[int, ...], dtype: Any, *,
                 scale: float = 1.0,
                 device: "torch.device | str | None" = None) -> torch.Tensor:
    """Deterministic non-constant example tensor for ``example_args``.

    Constant fills make the variant gate vacuous for some kernels —
    e.g. euclidean distances between identical all-ones rows are exactly
    zero, so any multiplicative corruption compares equal to the oracle.
    A short repeating ramp keeps outputs non-degenerate while staying
    cheap, seedless and bit-identical across processes — and to the JAX
    reference's ``example_fill``, including past 2**24 elements, where the
    float32 ramp index rounds (the index is converted from an exact
    integer, as an f32 iota is, and ``fmod`` is exact). ``scale`` caps the
    amplitude for kernels that exponentiate (attention softmax). Made on
    ``device``, the card by default.
    """
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=dev).to(torch.float32)
    vals = (torch.fmod(idx, 13.0) - 6.0) / 6.0 * scale
    return vals.reshape(tuple(int(s) for s in shape)).to(torch_dtype(dtype))


def torch_dtype(dtype: Any) -> torch.dtype:
    """``torch.float32`` from a torch dtype or its name (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype).removeprefix("torch."), None)
    if not isinstance(resolved, torch.dtype):
        raise TypeError(f"not a torch dtype: {dtype!r}")
    return resolved


def spec_capacity_kb(spec: Mapping[str, Any]) -> int:
    """The capacity a spec's tuning space is sized against, in kB.

    An explicit ``spec["vmem_kb"]`` wins; a spec on a CUDA device gets the
    card's shared memory per block; otherwise the reference's
    ``TPU_V5E.vmem_kb``, so CPU spaces equal the JAX package's.
    """
    if "vmem_kb" in spec:
        return int(spec["vmem_kb"])
    dev = torch.device(spec.get("device", "cpu"))
    return device_smem_kb(dev) if dev.type == "cuda" else TPU_V5E.vmem_kb


def spec_on_cuda(spec: Mapping[str, Any]) -> bool:
    """Whether a spec's kernel runs on a CUDA device: its space is then
    validated by what the Hopper kernel holds on chip (each kernel's
    ``hopper`` capacity rule), not by the TPU kernel's VMEM footprint."""
    return torch.device(spec.get("device", "cpu")).type == "cuda"


@dataclasses.dataclass(frozen=True)
class KernelDef:
    """Declarative description of one tunable kernel.

    ``generate(point, spec)`` must return the concrete callable for that
    tuning point with the spec's run-time constants closed over (on a
    CUDA ``spec["device"]``, the hand kernel's variant, built or resolved
    before it returns); ``extract_spec(*call_args, **overrides)`` maps
    live arguments (shapes/dtypes/device) to the spec dict that keys
    tuners, registry entries and generation-cache lines;
    ``example_args(spec)`` rebuilds concrete evaluation arguments from a
    spec alone.
    """

    name: str
    make_space: Callable[[Mapping[str, Any]], TuningSpace]
    generate: Callable[..., Callable[..., Any]]
    extract_spec: Callable[..., dict[str, Any]]
    cost_model: Callable[
        [Point, Mapping[str, Any], DeviceProfile], float] | None = None
    example_args: Callable[[Mapping[str, Any]], tuple] | None = None
    default_point: Point | None = None
    # sha256 prefix of the defining ops.py source, stamped by
    # discover_kernels: persisted bests and cached executables are keyed
    # under it, so editing a kernel's source cold-starts exactly that
    # kernel instead of warm-starting from stale bests
    source_hash: str | None = None
    # correctness reference: ``oracle(*example_args(spec))`` computes the
    # ground-truth output the variant gate compares a freshly generated
    # variant against (the kernel's ``ref.py``); ``tolerance`` supplies
    # per-kernel {"rtol": ..., "atol": ...} bounds for that comparison
    # (kernels accumulating in low precision declare looser ones)
    oracle: Callable[..., Any] | None = None
    tolerance: Mapping[str, float] | None = None
    # True where generating a CUDA variant compiles a binary at run time
    # (Triton): the compile farm's "process" backend then runs that
    # compile in a child process, which fills the on-disk cache the
    # parent's own generate loads from. The CUDA C++ families resolve a
    # symbol of a library built once: nothing to offload.
    process_compile: bool = False


class KernelCompilette(Compilette):
    """A :class:`~repro_torch.core.Compilette` bound to one kernel spec.

    Two generation backends, chosen at build time:

    * **real** (default): the kernel's ``generate`` produces the variant —
      on a CUDA device the hand kernel specialised for the point, resolved
      or compiled inside ``_build`` so the cost lands in
      ``generation_time_s``; on the CPU the eager PyTorch mirror.
    * **virtual** (``virtual=(clock, profile)``): generation returns a
      simulated kernel whose calls advance the injected
      :class:`~repro_torch.core.VirtualClock` by the analytical
      ``cost_model`` estimate — the deterministic backend of the
      virtual-clock tests.
    """

    def __init__(
        self,
        defn: KernelDef,
        spec: Mapping[str, Any],
        *,
        virtual: "tuple[Any, DeviceProfile] | None" = None,
        gen_cost_s: "float | Callable[..., float] | None" = None,
        cache_token: str | None = None,
    ) -> None:
        self.defn = defn
        self.spec = dict(spec)
        self.virtual = virtual
        # correctness gate hooks (read by repro_torch.core.gate.VariantGate):
        # the catalog oracle + tolerances, and an optional scripted
        # verdict ``gate_script(point) -> bool`` — the deterministic
        # pass/fail the virtual backend uses in place of real numerics
        # (installed by tests and the fault-injection replay harness)
        self.oracle = defn.oracle
        self.tolerance = dict(defn.tolerance) if defn.tolerance else None
        self.gate_script: Callable[[Point], bool] | None = None

        cost_model = None
        if defn.cost_model is not None:
            def cost_model(point, sp, profile, _d=defn):
                return _d.cost_model(point, {**self.spec, **sp}, profile)

        super().__init__(
            defn.name,
            defn.make_space(self.spec),
            self._build,
            cost_model=cost_model,
            gen_cost_s=gen_cost_s,
            cache_token=cache_token,
        )
        if defn.source_hash:
            # source identity reaches both persistence layers: the
            # coordinator appends fingerprint_extra to the registry
            # device key, and the generation cache keys on the token —
            # an edited ops.py invalidates this kernel's entries only
            self.fingerprint_extra = f"src-{defn.source_hash}"
            self.cache_token = (
                f"{self.cache_token}+{self.fingerprint_extra}"
                if self.cache_token else self.fingerprint_extra)

    # ------------------------------------------------------------ generate
    def _build(self, point: Point, **sp: Any) -> Callable[..., Any]:
        spec = {**self.spec, **sp}
        if self.virtual is not None:
            clock, profile = self.virtual
            if self.defn.cost_model is None:
                raise ValueError(
                    f"kernel {self.name!r} has no cost model: cannot "
                    "generate virtual variants")
            from repro_torch.core.evaluator import virtual_kernel
            return virtual_kernel(
                clock, self.defn.cost_model(dict(point), spec, profile),
                tag=dict(point))
        return self.defn.generate(dict(point), spec)

    # ----------------------------------------------------- process backend
    def process_payload(self, point: Point,
                        specialization: Mapping[str, Any]) -> tuple | None:
        """Picklable compile job for the farm's ``"process"`` backend.

        ``(module, attr, kwargs)`` naming :func:`compile_in_process`, which
        re-resolves this kernel from the child's own catalog and compiles
        the point there into Triton's on-disk cache (the directory is
        passed along: a cold cache set after the pool spawned is not in
        the child's environment). ``None`` (compile in-thread) for the
        virtual backend, for a spec off the card and for a kernel whose
        generation compiles nothing (``KernelDef.process_compile``).
        """
        spec = {**self.spec, **dict(specialization)}
        if (self.virtual is not None or not self.defn.process_compile
                or not spec_on_cuda(spec)):
            return None
        return ("repro_torch.kernels.catalog", "compile_in_process", {
            "kernel": self.defn.name,
            "point": dict(point),
            "spec": spec,
            "triton_cache_dir": os.environ.get("TRITON_CACHE_DIR"),
        })

    # ------------------------------------------------------------- helpers
    def has_valid_points(self) -> bool:
        """False when every point is a hole at this spec (untunable shape)."""
        return next(iter(self.space.iter_valid()), None) is not None

    def example_call_args(self) -> tuple:
        """Concrete arrays of the spec's shapes (evaluation fallback)."""
        if self.defn.example_args is None:
            raise ValueError(f"kernel {self.name!r} declares no example args")
        return self.defn.example_args(self.spec)


def compile_in_process(kernel: str, point: Mapping[str, Any],
                       spec: Mapping[str, Any],
                       triton_cache_dir: str | None = None) -> float:
    """Child-process entry for the compile farm's ``"process"`` backend.

    Resolves ``kernel`` from this process's own catalog and generates
    ``point`` — the compiled binary itself stays here (a loaded kernel
    does not pickle), but the compile fills Triton's on-disk cache under
    ``triton_cache_dir``, and the returned wall seconds let the parent
    charge the true compile cost.
    """
    if triton_cache_dir is not None:
        os.environ["TRITON_CACHE_DIR"] = triton_cache_dir
    comp = get_catalog().compilette(kernel, spec)
    start = time.perf_counter()
    comp._build(dict(point))
    return time.perf_counter() - start


class KernelCatalog:
    """Name → :class:`KernelDef` registry (one per process)."""

    def __init__(self) -> None:
        self._defs: dict[str, KernelDef] = {}

    def register(self, defn: KernelDef) -> KernelDef:
        self._defs[defn.name] = defn
        return defn

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._defs))

    def __contains__(self, name: str) -> bool:
        return name in self._defs

    def get(self, name: str) -> KernelDef:
        try:
            return self._defs[name]
        except KeyError:
            raise KeyError(
                f"unknown kernel {name!r}; discovered: "
                f"{', '.join(self.names()) or '(none)'}") from None

    def spec_of(self, name: str, *args: Any, **overrides: Any) -> dict:
        return self.get(name).extract_spec(*args, **overrides)

    def compilette(self, name: str, spec: Mapping[str, Any],
                   **opts: Any) -> KernelCompilette:
        return KernelCompilette(self.get(name), spec, **opts)


_CATALOG = KernelCatalog()
_DISCOVERED = False


def discover_kernels(catalog: KernelCatalog | None = None) -> KernelCatalog:
    """Import every ``repro_torch.kernels.<pkg>.ops`` and register its KERNEL.

    Idempotent; op packages without an ``ops`` module or a ``KERNEL``
    attribute are skipped silently (the kernels layer is optional). The
    scan walks the package path directly (the op directories are PEP-420
    namespace packages, which ``pkgutil.iter_modules`` does not list).
    """
    catalog = catalog if catalog is not None else _CATALOG
    import repro_torch.kernels as pkg

    sources: dict[str, str] = {}
    for root in pkg.__path__:
        for entry in sorted(os.listdir(root)):
            path = os.path.join(root, entry, "ops.py")
            if os.path.isfile(path):
                sources.setdefault(entry, path)
    for name in sorted(sources):
        try:
            mod = importlib.import_module(f"repro_torch.kernels.{name}.ops")
        except ImportError:
            continue
        defn = getattr(mod, "KERNEL", None)
        if isinstance(defn, KernelDef):
            if defn.source_hash is None:
                # stamp in place (the dataclass is frozen, but the ops
                # module's KERNEL object must keep its identity so
                # re-discovery stays idempotent)
                with open(sources[name], "rb") as fh:
                    digest = hashlib.sha256(fh.read()).hexdigest()[:12]
                object.__setattr__(defn, "source_hash", digest)
            catalog.register(defn)
    return catalog


def get_catalog() -> KernelCatalog:
    """The process-wide catalog, discovery run once on first use."""
    global _DISCOVERED
    if not _DISCOVERED:
        discover_kernels(_CATALOG)
        _DISCOVERED = True
    return _CATALOG
