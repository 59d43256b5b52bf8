"""Model FLOP utilisation of the window: the served work's useful FLOPs
(counted from the configuration's shapes: the products at the active
parameters, the causal scores and values, the head where logits are
taken, only the experts the router chose) over the window's time at the
bf16 peak."""

from pbench import yardstick as Y


def read(rec):
    s, w = rec["shapes"], rec["window"]
    flops = sum(Y.request_flops(s, b.batch, b.length, b.new_tokens) for b in w.batches)
    return 100.0 * flops / (w.seconds * Y.PEAK_BF16_FLOPS)
