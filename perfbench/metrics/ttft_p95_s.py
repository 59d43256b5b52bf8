"""95th percentile, over every request of the window, of the time to
first token: from its batch's ``generate`` call to the prefill's logits
on the device (host clock, after a sync)."""

from pbench.stats import nearest_rank


def read(rec):
    return nearest_rank([b.ttft_s for b in rec["window"].batches for _ in range(b.batch)],
                        0.95)
