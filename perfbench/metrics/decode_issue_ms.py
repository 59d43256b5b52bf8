"""The host's time issuing a decode step's work: the mean, over the
window's decode steps, of the ``serve.decode_step`` span less its
``serve.sync`` and ``tune.*`` children (the wait for the device and the
tuning slot), in milliseconds."""

from pbench.program_spans import requests


def read(rec):
    req = requests(rec)
    if req is None:
        return None
    steps = [r for r in req.of(req.window) if r.name == "serve.decode_step"]
    if not steps:
        return None
    kids = req.children({s.id for s in steps})
    issue = [s.seconds - sum(c.seconds for c in kids[s.id]
                             if c.name == "serve.sync" or c.name.startswith("tune."))
             for s in steps]
    return 1e3 * sum(issue) / len(issue)
