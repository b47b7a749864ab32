"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), in
PyTorch.  Counterpart of ``repro/layers/rglru.py``.

    r_t = sigmoid(W_a x_t)                recurrence gate
    i_t = sigmoid(W_x x_t)                input gate
    a_t = exp(-c * r_t * softplus(L))     c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence as ``jax.lax.associative_scan`` does (pairs
combined, the odd elements scanned recursively, the even ones filled in:
log S depth, no loop over S); decode carries ``h``.  The projections in
and out are quantized linears; the gates ``w_a`` / ``w_i`` stay float
(``core.api.FLOAT_PARENTS``) and the recurrence is elementwise f32, as in
the reference.

Under partitioned rules (``distributed/partition.py``) a rank may hold a
slice of d_rnn: the columns of w_gate, w_in, w_a and w_i, those features
of ``conv_w`` and ``lam`` and of the state, and w_out's slice of K.  The
scan, the step, the temporal conv and the gates act per feature, so they
run on the slice as they are; w_out is row-parallel, its int32 sums
reduced over "model" and its activation grid maxed over the slices.  A
decode step's float gates run as matmuls of one fixed shape
(:func:`gate_step`), so a feature's gate is the same bits whatever slice
of rows and features a rank holds.  In training (modes "float" and
"fake") the same two places exchange: x enters the rank's columns
through ``partition.model_input`` (its gradient summed over "model") and
w_out's fake product sums its f32 partials over "model" on a grid maxed
over the slices (``core/api.py::dense``); the rest of the backward is per
feature.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.api import QuantConfig, dense
from repro_torch.distributed import partition
from repro_torch.layers.mlp import gelu, logistic, softplus, whole_vectors

C_MULT = 8.0
CONV_WIDTH = 4
GATE_ROWS, GATE_COLS = 16, 1024      # the one shape of gate_step's matmuls


def _log_a(lam, r):
    # log a_t = -c * r_t * softplus(Lambda)  (so 0 < a_t < 1)
    return -C_MULT * r * softplus(lam)


def _gated_input(log_a, i, x):
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return gated * (i.to(torch.float32) * x.to(torch.float32))


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """e0, o0, e1, o1, ... along axis 1 (``even`` may be one longer)."""
    n = even.shape[1] + odd.shape[1]
    if odd.shape[1] < even.shape[1]:
        odd = torch.cat([odd, torch.zeros_like(even[:, :1])], dim=1)
    out = torch.stack([even, odd], dim=2)
    return out.reshape(even.shape[0], -1, *even.shape[2:])[:, :n]


def _assoc_scan(a, b):
    """Inclusive scan of ``(a, b)`` under :func:`_combine` along axis 1, in
    ``jax.lax.associative_scan``'s order of operations."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _assoc_scan(*_combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                                   a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(x, r, i, lam):
    """x, r, i: (B, S, D); lam: (D,).  Returns h (B, S, D) in x's dtype and
    h_last (B, D) f32."""
    log_a = _log_a(lam, r.to(torch.float32))
    _, h = _assoc_scan(torch.exp(log_a), _gated_input(log_a, i, x))
    return h.to(x.dtype), h[:, -1]


def rglru_step(x, r, i, lam, h_prev):
    """One decode step: x, r, i (B, D); h_prev (B, D) f32."""
    log_a = _log_a(lam, r.to(torch.float32))
    h = torch.exp(log_a) * h_prev + _gated_input(log_a, i, x)
    return h.to(x.dtype), h


def temporal_conv(x, w, state=None):
    """Depthwise width-4 causal conv.  x (B, S, D), w (CONV_WIDTH, D);
    ``state`` (B, CONV_WIDTH - 1, D) the trailing context for decode.
    Returns (y, new_state f32); the taps sum in the reference's order."""
    if state is None:
        pad = torch.zeros_like(x[:, :CONV_WIDTH - 1])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = xp[:, :s] * w[CONV_WIDTH - 1]
    for k in range(1, CONV_WIDTH):
        y = y + xp[:, k:k + s] * w[CONV_WIDTH - 1 - k]
    return y, xp[:, -(CONV_WIDTH - 1):].to(torch.float32)


def gate_step(x, w):
    """A float gate ``x @ w`` at one position: x (B, 1, K), w (K, N).  It
    runs as matmuls of GATE_ROWS rows by GATE_COLS columns, x's rows and
    w's last block of columns zero-padded, every call the same shape, so
    each output is the same bits for any B and N: a partitioned rank's
    rows and columns give the one-rank values.  (At a few rows cuBLAS
    picks its reduction by the shape it is given, so one matmul over a
    slice of the columns would not: ``chip_smoke.py`` ``[tp-families]``
    prints both.)"""
    b, n = x.shape[0], w.shape[-1]
    xs = F.pad(x[:, 0], (0, 0, 0, (-b) % GATE_ROWS))
    blocks = [w[:, j:j + GATE_COLS] for j in range(0, n, GATE_COLS)]
    if n % GATE_COLS:
        blocks[-1] = F.pad(blocks[-1], (0, GATE_COLS - n % GATE_COLS))
    return torch.cat([
        torch.cat([torch.matmul(xs[i:i + GATE_ROWS], blk) for blk in blocks],
                  -1) for i in range(0, xs.shape[0], GATE_ROWS)
    ])[:b, None, :n]


def rglru_block(x, p: dict, cfg: QuantConfig | None, *, state=None,
                k_split: bool = False, seq: bool = False):
    """The Griffin recurrent block.  x (B, S, d); ``state`` None (prefill:
    the scan from h = 0) or ``{"h": (B, Drnn) f32, "conv": (B, 3, Drnn)
    f32}`` (decode, S == 1).  ``k_split``: under partitioned rules, ``p``
    and ``state`` hold this rank's slice of Drnn.  ``seq``
    (``partition.seq_split``): x holds this rank's chunk of the sequence,
    gathered before the products, and y is the rank's chunk (w_out
    reduce-scattered); the scan runs on the whole sequence.  Returns (y,
    new state)."""
    x = partition.model_input(x, k_split, seq)
    gate_branch = gelu(dense(x, p["w_gate"], cfg))
    u = dense(x, p["w_in"], cfg)
    u, new_conv = temporal_conv(u, p["conv_w"],
                                None if state is None else state["conv"])
    if state is None:                           # small gates stay float
        r = whole_vectors(logistic, dense(x, p["w_a"], None))
        i = whole_vectors(logistic, dense(x, p["w_i"], None))
        h, h_last = rglru_scan(u, r, i, p["lam"])
    else:
        r = whole_vectors(logistic, gate_step(x, p["w_a"]["w"]))
        i = whole_vectors(logistic, gate_step(x, p["w_i"]["w"]))
        h, h_last = rglru_step(u[:, 0], r[:, 0], i[:, 0], p["lam"],
                               state["h"])
        h = h[:, None]
    y = dense(h * gate_branch, p["w_out"], cfg, tp="row", k_split=k_split,
              seq=seq)
    return y, {"h": h_last, "conv": new_conv}


def init_rglru(gen: torch.Generator, d: int, d_rnn: int, dtype, *, lead=(),
               device="cuda") -> dict:
    """Random weights (``lead``: stacked layer axes), the reference's keys
    and scales."""
    def lin(din, dout):
        w = torch.randn((*lead, din, dout), generator=gen, device=device)
        return {"w": (w * din ** -0.5).to(dtype)}

    conv = torch.randn((*lead, CONV_WIDTH, d_rnn), generator=gen,
                       device=device)
    lam = torch.linspace(0.5, 4.0, d_rnn, device=device)
    return {"w_gate": lin(d, d_rnn), "w_in": lin(d, d_rnn),
            "w_a": lin(d, d_rnn), "w_i": lin(d, d_rnn),
            "w_out": lin(d_rnn, d), "conv_w": (conv * 0.1).to(dtype),
            "lam": lam.expand(*lead, d_rnn).clone()}


def init_rglru_state(batch: int, d_rnn: int, *, lead=(),
                     device="cuda") -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((*lead, batch, d_rnn), **f32),
            "conv": torch.zeros((*lead, batch, CONV_WIDTH - 1, d_rnn), **f32)}
