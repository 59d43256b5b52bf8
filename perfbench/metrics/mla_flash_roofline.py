"""Latent attention's expanded prefill against its roofline in the traced
stretch: each recorded flash call's least time from the kind's counts of
it (``flash_call``: scores over q's and k's head dim, values over v's,
bf16 FLOPs at the peak or bytes at HBM's rate, the larger) over the
device time of the kernels launched inside the flash calls. Nothing
where the kind has no such count."""

from pbench import yardstick as Y
from pbench.spec import kind_of


def read(rec):
    t = rec["trace"]
    if not t or not t["flash_calls"]:
        return None
    count = getattr(kind_of(rec["shapes"]), "flash_call", None)
    device_s = t["range_device_s"].get("flash", 0.0)
    if count is None or device_s <= 0:
        return None
    least = sum(Y.roofline_s(*count(rec["shapes"], c)) for c in t["flash_calls"])
    return 100.0 * least / device_s
