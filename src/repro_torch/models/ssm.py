"""Selective SSM (Mamba-style) branch used by the Hymba hybrid.

Mirrors ``repro/models/ssm.py``. Diagonal data-dependent SSM:
    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + (Δ_t x_t) ⊗ B_t
    y_t = C_t · h_t + D ⊙ x_t
with a short causal depthwise conv + SiLU in front and a SiLU output gate.

Prefill and training use a chunk-parallel scan (chunk length =
``scan_chunk``, auto-tunable); decode keeps (conv buffer, h) state — O(1)
per token.

**The scan.** PyTorch has no ``associative_scan``. Inside each chunk the
recurrence ``h_t = a_t h_{t-1} + b_t`` is a log-depth doubling scan over
the chunk axis (``ceil(log2 Lc)`` elementwise passes, every chunk of the
sequence at once), with the reference's combine ``(a1, b1), (a2, b2) ->
(a1 a2, a2 b1 + b2)``; a Python loop over the chunks then carries ``h``
from one chunk to the next, as the reference's ``lax.scan`` does. The
products of ``a`` stay products: a cumulative sum of ``log a`` read back
through ``exp(-L)`` would overflow fp32 over a chunk at hymba's decays,
and a loop over tokens would cost a launch per token and layer.

The reference's ``shard`` annotations stand at its own sites: under
DTensor (a sharded run) the inner channels follow ``heads`` over the
model axis, every region on local shards with its placements stated
(:func:`_ssm_sharded`), the input-dependent B, C and step (contractions
over the channels) reduced before the scan.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import shard
from repro_torch.models.params import ParamDef


def ssm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_model          # inner width = d_model (parallel-branch hybrid)
    st = cfg.ssm_state
    ck = cfg.ssm_conv
    s = 1.0 / math.sqrt(d)
    return {
        "w_in": ParamDef((d, 2 * di), ("embed", "heads"), scale=s),
        "conv_w": ParamDef((ck, di), (None, "heads"), scale=0.5),
        "w_b": ParamDef((di, st), ("heads", None), scale=1.0 / math.sqrt(di)),
        "w_c": ParamDef((di, st), ("heads", None), scale=1.0 / math.sqrt(di)),
        "w_dt": ParamDef((di, 1), ("heads", None), scale=1.0 / math.sqrt(di)),
        "dt_bias": ParamDef((di,), ("heads",), init="zeros"),
        "a_log": ParamDef((di, st), ("heads", None), init="zeros"),
        "d_skip": ParamDef((di,), ("heads",), init="ones"),
        "w_out": ParamDef((di, d), ("heads", "embed"), scale=1.0 / math.sqrt(di)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prev: torch.Tensor | None):
    """Depthwise causal conv. x: (B, T, di); w: (ck, di);
    prev: (B, ck-1, di) decode buffer or None (zero history)."""
    ck = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], ck - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)                 # (B, T+ck-1, di)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i][None, None] for i in range(ck))
    new_prev = xp[:, -(ck - 1):] if ck > 1 else prev
    return out, new_prev


def _doubling_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of ``(a, b)`` under the reference's combine along
    ``dim``: after the pass at ``shift``, element t holds the combination
    of elements ``t - 2*shift + 1 .. t``."""
    L = a.shape[dim]
    shift = 1
    while shift < L:
        a_head, a_tail = a.narrow(dim, 0, shift), a.narrow(dim, shift, L - shift)
        b_tail = b.narrow(dim, shift, L - shift)
        a_prev, b_prev = a.narrow(dim, 0, L - shift), b.narrow(dim, 0, L - shift)
        b = torch.cat([b.narrow(dim, 0, shift), a_tail * b_prev + b_tail], dim=dim)
        a = torch.cat([a_head, a_tail * a_prev], dim=dim)
        shift *= 2
    return a, b


def ssm_scan_chunked(a, b, h0, chunk: int):
    """Chunked scan of h_t = a_t h_{t-1} + b_t (see the module docstring).

    a, b: (B, T, di, st); h0: (B, di, st). Returns (h_all, h_final)."""
    B, T, di, st = a.shape
    Lc = min(chunk, T)
    n = -(-T // Lc)
    Tp = n * Lc
    if Tp != T:
        # identity padding: a=1 (no decay), b=0 → state frozen past T
        a = torch.cat([a, a.new_ones((B, Tp - T, di, st))], dim=1)
        b = torch.cat([b, b.new_zeros((B, Tp - T, di, st))], dim=1)
    a_cum, b_cum = _doubling_scan(a.reshape(B, n, Lc, di, st),
                                  b.reshape(B, n, Lc, di, st), dim=2)
    h = h0
    outs = []
    for c in range(n):
        h_all = a_cum[:, c] * h[:, None] + b_cum[:, c]    # (B, Lc, di, st)
        outs.append(h_all)
        h = h_all[:, -1]
    return torch.cat(outs, dim=1)[:, :T], h


def ssm_branch(x, p, cfg: ModelConfig, *, state=None):
    """x: (B, T, d). state: (conv_buf, h) or None.
    Returns (y, new_state)."""
    conv_buf, h0 = state if state is not None else (None, None)
    if shlib.is_dtensor(x):
        return _ssm_sharded(x, p, cfg, conv_buf, h0)
    xz = torch.matmul(x, p["w_in"].to(x.dtype))
    xi, z = torch.chunk(xz, 2, dim=-1)                    # (B, T, di) each
    xi = shard(xi, "batch", "seq", "heads")
    xi, conv_buf = _causal_conv(xi, p["conv_w"].to(x.dtype), conv_buf)
    xf = F.silu(xi).to(torch.float32)
    bt = torch.matmul(xf, p["w_b"].to(torch.float32))     # (B, T, st)
    ct = torch.matmul(xf, p["w_c"].to(torch.float32))
    # rank-1 data-dependent step size (scalar per token + per-channel bias)
    dt_raw = torch.matmul(xf, p["w_dt"].to(torch.float32))  # (B, T, 1)
    y, h_last = _scan(xf, bt, ct, dt_raw, p["dt_bias"], p["a_log"], p["d_skip"], z,
                      h0, cfg, x.dtype)
    out = torch.matmul(y, p["w_out"].to(x.dtype))
    return shard(out, "batch", "seq", "embed"), (conv_buf, h_last)


def _scan(xf, bt, ct, dt_raw, dt_bias, a_log, d_skip, z, h0, cfg: ModelConfig, dtype):
    """The step, the scan and the gated output over the channels of
    ``xf`` (all of them, or a rank's own): (y, h_last)."""
    B, T, di = xf.shape
    dt = F.softplus(dt_raw + dt_bias.to(torch.float32)[None, None])  # (B, T, di)
    A = -torch.exp(a_log.to(torch.float32))               # (di, st), negative
    a = torch.exp(dt[..., None] * A[None, None])          # (B, T, di, st)
    b = (dt * xf)[..., None] * bt[:, :, None, :]          # (B, T, di, st)
    if h0 is None:
        h0 = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32, device=xf.device)
    if T == 1:
        h_last = a[:, 0] * h0 + b[:, 0]
        h_all = h_last[:, None]
    else:
        h_all, h_last = ssm_scan_chunked(a, b, h0, cfg.scan_chunk)
    y = torch.einsum("btds,bts->btd", h_all, ct)          # (B, T, di)
    y = y + d_skip.to(torch.float32)[None, None] * xf
    return y.to(dtype) * F.silu(z), h_last


def _ssm_sharded(x, p, cfg: ModelConfig, conv_buf, h0):
    """:func:`ssm_branch` with the inner channels over the ``heads`` mesh
    axis, each region on local shards (:func:`~repro_torch.distributed.
    sharding.pinned`): the input projection (each rank takes its channels'
    columns of both halves of ``w_in``), the conv, the three
    contractions over the channels (pending sums, reduced before the
    scan), the scan, and the output projection (a pending sum)."""
    B, T, d = x.shape
    di, st = p["w_in"].shape[1] // 2, cfg.ssm_state
    row, chan = ("batch", "seq", "embed"), ("batch", "seq", "heads")
    n, lo = shlib.pinned_range((B, T, di), chan, x.device_mesh, 2)

    def in_proj(xl, wl):
        w = wl.to(xl.dtype)
        return (torch.matmul(xl, w[:, lo:lo + n]),
                torch.matmul(xl, w[:, di + lo:di + lo + n]))

    xi, z = shlib.pinned(in_proj, x, p["w_in"], axes=(row, ("embed", None)),
                         out_axes=(chan, chan), out_shape=((B, T, di),) * 2,
                         out_dtype=(x.dtype,) * 2)
    def conv(xl, wl, bl):
        out, bl = _causal_conv(xl, wl.to(xl.dtype), bl)
        return F.silu(out).to(torch.float32), bl

    ck = p["conv_w"].shape[0]
    buf = ("batch", None, "heads")
    xf, conv_buf = shlib.pinned(
        conv, xi, p["conv_w"], conv_buf, axes=(chan, None, buf),
        out_axes=(chan, buf), out_shape=((B, T, di), (B, ck - 1, di)),
        out_dtype=(torch.float32, x.dtype))
    bt, ct, dt_raw = (shlib.settle(shlib.pinned(
        lambda xl, wl: torch.matmul(xl, wl.to(torch.float32)), xf, p[w],
        axes=(chan, None), out_axes=("batch", "seq", None),
        out_shape=(B, T, p[w].shape[1]), out_dtype=torch.float32))
        for w in ("w_b", "w_c", "w_dt"))
    y, h_last = shlib.pinned(
        lambda *a: _scan(*a, cfg, x.dtype),
        xf, bt, ct, dt_raw, p["dt_bias"], p["a_log"], p["d_skip"], z, h0,
        axes=(chan, *(("batch", "seq", None),) * 3, None, None, None, chan,
              ("batch", "heads", None)),
        out_axes=(chan, ("batch", "heads", None)), out_shape=((B, T, di), (B, di, st)),
        out_dtype=(x.dtype, torch.float32))
    out = shlib.pinned(lambda yl, wl: torch.matmul(yl, wl.to(yl.dtype)), y, p["w_out"],
                       axes=(chan, None), out_axes=row, out_shape=(B, T, d),
                       out_dtype=x.dtype)
    return shard(out, "batch", "seq", "embed"), (conv_buf, h_last)
