"""Prompt tokens a second of the serve loop's prefill: the window's prompt
tokens over the sum of ``generate``'s ``prefill_s`` spans."""


def read(rec):
    batches = rec["window"].batches
    return sum(b.batch * b.length for b in batches) / sum(b.prefill_s for b in batches)
