"""95th percentile, over every request of the window, of the time per
output token after the first: from the first token to ``generate``'s
return (every token synced), over the tokens after the first."""

from pbench.stats import nearest_rank


def read(rec):
    batches = [b for b in rec["window"].batches if b.new_tokens > 1]
    if not batches:
        return None
    return 1e3 * nearest_rank([b.tpot_s for b in batches for _ in range(b.batch)], 0.95)
