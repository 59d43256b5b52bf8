"""The host's time in latent attention a decode step: the ``mla.*``
spans (the layer tier, recorded under the profiler: projection, the
absorbed query, the attention over the latent cache, the values out)
inside the traced stretch's decode steps, summed over the layers, in
milliseconds a step."""

from pbench.program_spans import requests


def read(rec):
    req = requests(rec)
    if req is None:
        return None
    mine = req.of(req.traced)
    steps = {r.id for r in mine if r.name == "serve.decode_step" and r.profiled}
    seconds = 0.0
    seen = False
    for r in mine:
        if r.name.startswith("mla."):
            step = req.ancestor(r, lambda p: p.name == "serve.decode_step")
            if step is not None and step.id in steps:
                seconds += r.seconds
                seen = True
    if not seen:
        return None
    return 1e3 * seconds / len(steps)
