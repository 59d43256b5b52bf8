"""Flash attention's share of its roofline in the traced stretch: each
call's least time from its shapes (bf16 FLOPs at the peak or its bytes
at HBM's rate, the larger) over the device time of the kernels launched
inside the calls."""

from pbench import yardstick as Y


def read(rec):
    t = rec["trace"]
    if not t or not t["flash_calls"]:
        return None
    device_s = t["range_device_s"].get("flash", 0.0)
    if device_s <= 0:
        return None
    least = sum(Y.roofline_s(*Y.flash_call(*c)) for c in t["flash_calls"])
    return 100.0 * least / device_s
