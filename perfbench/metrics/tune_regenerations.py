"""Variants the tuner regenerated and evaluated in the window: the change
of the session's ``regenerations`` counter."""


def read(rec):
    w = rec["window"]
    return w.counters1["regenerations"] - w.counters0["regenerations"]
