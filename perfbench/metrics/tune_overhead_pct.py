"""The tuner's share of the window: the change of the session's
``tuning_spent_s`` counter over the window, against the window's time."""


def read(rec):
    w = rec["window"]
    return 100.0 * (w.counters1["tuning_spent_s"] - w.counters0["tuning_spent_s"]) / w.seconds
