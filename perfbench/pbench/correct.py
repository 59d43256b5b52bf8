"""The comparison that decides ``correct``.

After the window has closed, ``memory_peak_bytes`` has been read and the
program's state is freed, whole batches of the window drawn from the
seed (one of the longest prompts always among them) go to the plain
reference: each sequence, its prompt and its served tokens, in float32.
A served token is greedy, so the reference's logit of it should be its
best up to rounding: the number compared is the widest gap by which a
served token's reference logit lies below the reference's best logit at
that position. The reference is the kind's ``served_logits``
(``perfbench/reference/<kind>.py``). Its limit is the cell's
(``perfbench/limits/<cell>.json``), set from the program's readings on a
dozen seeds and more and from the control's (the reference itself in
float8 products: :func:`control_gaps`).
"""

from __future__ import annotations

import torch

from pbench import traffic

GAP = "max_logit_gap"
MEAN = "mean_logit_gap"


def logit_gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(B, n) gaps: the reference's best logit less its logit of ``chosen``."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, chosen[..., None].long())[..., 0]
    return best - got


def control_gaps(ref_logits: torch.Tensor, control_logits: torch.Tensor) -> torch.Tensor:
    """The gaps of the tokens the control puts first at the same positions."""
    return logit_gaps(ref_logits, control_logits.argmax(dim=-1))


def sampled(ctx, batches) -> list:
    picked = traffic.check_sample(ctx.mix, len(batches), ctx.seed)
    return [batches[i] for i in picked]


def summary(gaps: list[torch.Tensor], prefix: str = "") -> dict:
    """The numbers a cell may compare, from every served token's gap."""
    g = torch.cat([x.flatten().double().cpu() for x in gaps])
    return {prefix + GAP: float(g.max()), prefix + MEAN: float(g.mean())}


def compare(ctx, batches, *, witnesses: tuple[str, ...] = ()) -> dict:
    """Gaps of the served tokens of the sampled ``batches``; for each of
    ``witnesses`` (``"fp8"``: the control; ``"bf16"``), the gaps of the
    tokens the reference in those products puts first."""
    conf = ctx.conf
    ref = ctx.kind
    gaps: list = []
    other: dict[str, list] = {w: [] for w in witnesses}
    n_tokens = n_requests = 0
    for rec in sampled(ctx, batches):
        prompts = ctx.prompts[rec.index]
        served = rec.tokens.to(prompts.device)
        want = ref.served_logits(ctx.params, conf, prompts, served)
        gaps.append(logit_gaps(want, served))
        for w in witnesses:
            got = ref.served_logits(ctx.params, conf, prompts, served, products=w)
            other[w].append(control_gaps(want, got))
            del got
        n_tokens += served.numel()
        n_requests += served.shape[0]
        del want
    out = {**summary(gaps), "tokens": n_tokens, "requests": n_requests}
    for w in witnesses:
        out.update(summary(other[w], prefix=w + "_"))
    return out


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each number the cell compares (its limits file names them) beside
    its limit; correct when every one is within it. A cell with no limit
    is not correct."""
    checks = {name: {"value": readings[name], "limit": lim["limit"]}
              for name, lim in limits.items() if name in readings}
    ok = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
