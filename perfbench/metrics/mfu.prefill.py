"""Model FLOP utilisation of the prefill steps: the prefills' useful FLOPs
over the sum of ``generate``'s ``prefill_s`` spans at the bf16 peak."""

from pbench import yardstick as Y


def read(rec):
    s, batches = rec["shapes"], rec["window"].batches
    flops = sum(Y.prefill_flops(s, b.batch, b.length) for b in batches)
    return 100.0 * flops / (sum(b.prefill_s for b in batches) * Y.PEAK_BF16_FLOPS)
