"""Mamba-2 SSD (state-space duality, arXiv:2405.21060), chunked algorithm,
in PyTorch.  Counterpart of ``repro/layers/ssd.py``.

Per head: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T;  y_t = C_t h_t.
Within a chunk the terms are a masked quadratic contraction; the state
crosses chunks by a scan (a loop over the S / chunk chunks).  The in / out
projections are quantized linears; the recurrence is f32 einsums over the
state, outside any kernel, as in the reference.

Under partitioned rules (``distributed/partition.py``) the mixer is whole
on every rank, as the reference's ``param_specs`` keeps it (``in_proj`` /
``out_proj`` replicated), and runs on the rank's batch rows with its
rows of the state: nothing crosses ranks.  A decode step's contraction
over the state is a sum of products (:func:`ssd_step`), so a rank's rows
give the one-rank bits.  In training the gradient reaching the mixer is
whole on every model rank, so each model rank computes its leaves' whole
gradient from its rows, and the train step sums them over the batch axes
only (``partition.reduce_grads``), never over "model".
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.api import QuantConfig, dense
from repro_torch.layers.mlp import silu, softplus
from repro_torch.layers.norms import rmsnorm
from repro_torch.layers.rglru import CONV_WIDTH, temporal_conv

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_state: int = 128     # N
    head_dim: int = 64     # P
    expand: int = 2        # d_inner = expand * d_model
    n_groups: int = 1      # G (B/C shared across heads per group)
    chunk: int = 64        # Q


def _segsum(log_a):
    """out[..., i, j] = sum_{j<k<=i} log_a[..., k] as the reference forms
    it (a cumsum difference), -inf above the diagonal."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, scfg: SSDConfig, h0=None):
    """x (b, s, h, p); dt (b, s, h); A (h,); B, C (b, s, g, n).  Returns y
    (b, s, h, p) in x's dtype and the final state (b, h, p, n) f32.  The
    chunk is the largest one <= ``scfg.chunk`` that divides s."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = next(c for c in range(min(scfg.chunk, s), 0, -1) if s % c == 0)
    nc = s // q
    rep = h // g

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h).to(_F32)
    Bh = torch.repeat_interleave(B.reshape(b, nc, q, g, n).to(_F32), rep, 3)
    Ch = torch.repeat_interleave(C.reshape(b, nc, q, g, n).to(_F32), rep, 3)
    la = dtc * A.to(_F32)                                  # log a (b,nc,q,h)
    xdt = xc.to(_F32) * dtc[..., None]

    # intra-chunk: y[i] = sum_{j<=i} C_i.B_j L_ij x~_j
    L = torch.exp(_segsum(la.movedim(3, 2)))                # (b,nc,h,q,q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    y_intra = torch.einsum("bchqk,bchqk,bckhp->bcqhp", scores, L, xdt)

    # each chunk's contribution to the state
    cum = torch.cumsum(la, dim=2)
    tot = cum[:, :, -1]                                     # (b,nc,h)
    decay_rest = torch.exp(tot[:, :, None] - cum)
    chunk_state = torch.einsum("bcqhn,bcqhp,bcqh->bchpn", Bh, xdt,
                               decay_rest)

    # inter-chunk scan over the carried state (b, h, p, n)
    carry = torch.zeros((b, h, p, n), dtype=_F32, device=x.device) \
        if h0 is None else h0
    before = []
    for c in range(nc):
        before.append(carry)                                # state BEFORE c
        carry = carry * torch.exp(tot[:, c])[..., None, None] + \
            chunk_state[:, c]
    h_prev = torch.stack(before, dim=1)                     # (b,nc,h,p,n)

    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, h_prev,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_step(x, dt, A, B, C, h_prev):
    """Decode: x (b, h, p), dt (b, h), B, C (b, g, n), h_prev (b, h, p, n)."""
    rep = x.shape[1] // B.shape[1]
    Bh = torch.repeat_interleave(B.to(_F32), rep, 1)
    Ch = torch.repeat_interleave(C.to(_F32), rep, 1)
    dtf = dt.to(_F32)
    a = torch.exp(dtf * A.to(_F32))                         # (b,h)
    upd = torch.einsum("bhn,bhp,bh->bhpn", Bh, x.to(_F32), dtf)
    h = h_prev * a[..., None, None] + upd
    # y = einsum("bhn,bhpn->bhp"), as products and a sum over n: on the
    # card the einsum's batched product is chosen by the rows it is given,
    # so a rank's rows would part from the one-rank batch's (chip_smoke.py
    # [tp-families] prints it); the sum keeps one block shape from 16
    # outputs up (layers/norms.py)
    y = (Ch[:, :, None, :] * h).sum(-1)
    return y.to(x.dtype), h


def in_proj_width(d: int, scfg: SSDConfig) -> int:
    """Output features of ``in_proj``: z, x, B, C and dt."""
    d_inner = scfg.expand * d
    return 2 * d_inner + 2 * scfg.n_groups * scfg.d_state + \
        d_inner // scfg.head_dim


def ssd_block(x, p: dict, scfg: SSDConfig, cfg: QuantConfig | None, *,
              state=None):
    """The Mamba-2 block.  x (B, S, d); ``state`` None (prefill, from a
    zero state) or ``{"h": (B, H, P, N) f32, "convs": (B, 3, d_conv)
    f32}`` (decode, S == 1).  Returns (y, new state)."""
    bsz, s, d = x.shape
    d_inner = scfg.expand * d
    h = d_inner // scfg.head_dim
    g, n = scfg.n_groups, scfg.d_state

    z, xs, B, C, dt = torch.split(dense(x, p["in_proj"], cfg),
                                  [d_inner, d_inner, g * n, g * n, h], dim=-1)
    xbc, new_conv = temporal_conv(silu(torch.cat([xs, B, C], dim=-1)),
                                  p["conv_w"],
                                  None if state is None else state["convs"])
    xs, B, C = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    dt = softplus(dt.to(_F32) + p["dt_bias"])

    xh = xs.reshape(bsz, s, h, scfg.head_dim)
    Bg = B.reshape(bsz, s, g, n)
    Cg = C.reshape(bsz, s, g, n)
    if state is None:
        y, hT = ssd_chunked(xh, dt, p["A_log"], Bg, Cg, scfg)
    else:
        y1, hT = ssd_step(xh[:, 0], dt[:, 0], p["A_log"], Bg[:, 0], Cg[:, 0],
                          state["h"])
        y = y1[:, None]
    y = y + xh * p["D"][None, None, :, None]                # skip connection
    y = rmsnorm(y.reshape(bsz, s, d_inner) * silu(z), p["norm_gamma"])
    return dense(y, p["out_proj"], cfg), {"h": hT, "convs": new_conv}


def init_ssd(gen: torch.Generator, d: int, scfg: SSDConfig, dtype, *,
             lead=(), device="cuda") -> dict:
    """Random weights (``lead``: stacked layer axes), the reference's keys
    and scales."""
    d_inner = scfg.expand * d
    h = d_inner // scfg.head_dim
    g, n = scfg.n_groups, scfg.d_state
    d_in_proj = in_proj_width(d, scfg)
    d_conv = d_inner + 2 * g * n

    def randn(*shape):
        return torch.randn((*lead, *shape), generator=gen, device=device)

    f32 = dict(dtype=_F32, device=device)
    return {
        "in_proj": {"w": (randn(d, d_in_proj) * d ** -0.5).to(dtype)},
        "out_proj": {"w": (randn(d_inner, d) * d_inner ** -0.5).to(dtype)},
        "conv_w": (randn(CONV_WIDTH, d_conv) * 0.1).to(dtype),
        "dt_bias": torch.zeros((*lead, h), **f32),
        "A_log": -torch.exp(randn(h)),
        "D": torch.ones((*lead, h), **f32),
        "norm_gamma": torch.ones((*lead, d_inner), **f32),
    }


def init_ssd_state(batch: int, d: int, scfg: SSDConfig, *, lead=(),
                   device="cuda") -> dict:
    d_inner = scfg.expand * d
    h = d_inner // scfg.head_dim
    d_conv = d_inner + 2 * scfg.n_groups * scfg.d_state
    f32 = dict(dtype=_F32, device=device)
    return {"h": torch.zeros((*lead, batch, h, scfg.head_dim, scfg.d_state),
                             **f32),
            "convs": torch.zeros((*lead, batch, CONV_WIDTH - 1, d_conv),
                                 **f32)}
