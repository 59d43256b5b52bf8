"""The time the serving thread stood still in tuner work, as a share of
the window: the seconds of the outermost ``tune.*`` spans (a tuning
slot, a registration with its reference measurement, an evaluation) on
the thread of each window request, over the window's seconds."""

from pbench.program_spans import requests


def read(rec):
    req = requests(rec)
    if req is None or rec["window"].seconds <= 0:
        return None
    thread = {g.request: g.thread for g in req.window}
    inline = 0.0
    for r in req.of(req.window):
        if (r.name.startswith("tune.") and r.thread == thread[r.request]
                and req.ancestor(r, lambda p: p.name.startswith("tune.")) is None):
            inline += r.seconds
    return 100.0 * inline / rec["window"].seconds
