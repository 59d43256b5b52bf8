"""Milliseconds a decode step: the sum of ``generate``'s ``decode_s`` spans
over the window's decode steps."""


def read(rec):
    batches = rec["window"].batches
    steps = sum(b.new_tokens - 1 for b in batches)
    if not steps:
        return None
    return 1e3 * sum(b.decode_s for b in batches) / steps
