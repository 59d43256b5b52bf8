"""The 90th percentile, by nearest rank, of the window's decode steps:
the durations of the program's ``serve.decode_step`` spans (the model
call, the argmax, the sync that closes the step, the tuning slot after
it), in milliseconds."""

from pbench.program_spans import requests
from pbench.stats import nearest_rank


def read(rec):
    req = requests(rec)
    if req is None:
        return None
    steps = [r.seconds for r in req.of(req.window) if r.name == "serve.decode_step"]
    if not steps:
        return None
    return 1e3 * nearest_rank(steps, 0.9)
