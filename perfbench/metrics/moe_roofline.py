"""The expert layer's share of its roofline in the traced stretch: each
``moe_ffn`` call's least time (the router and each token's top-k
experts' products at the bf16 peak, or the router, each expert the
routing chose read once and the activations at HBM's rate, the larger)
over the device time of the kernels launched inside the calls."""

from pbench import yardstick as Y


def read(rec):
    t = rec["trace"]
    if not t or not t["moe_calls"]:
        return None
    device_s = t["range_device_s"].get("moe_ffn", 0.0)
    if device_s <= 0:
        return None
    least = sum(Y.roofline_s(*Y.moe_call(rec["shapes"], n, used)) for n, used in t["moe_calls"])
    return 100.0 * least / device_s
