"""Tokens generated a second: every token of the window's requests (the
prefill's first one included) over the window, from its start (the
tuning session opened) to the last batch's end."""


def read(rec):
    w = rec["window"]
    return sum(b.batch * b.new_tokens for b in w.batches) / w.seconds
