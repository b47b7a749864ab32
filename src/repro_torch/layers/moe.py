"""Mixture-of-Experts FFN: top-k routing, capacity dispatch — in PyTorch.

Counterpart of ``repro/layers/moe.py``, single-device body: token slots
are assigned with a cumulative count over expert ids, tokens beyond an
expert's capacity are dropped (weight zero), and the expert FFNs run as
batched ``(E, C, d)`` contractions through :func:`dense_expert`, so the
paper's reordering applies to MoE unchanged.  In ``int`` mode the expert
products take the qmatmul kernel, one launch an expert
(``kernels/dispatch.py::maybe_qexpert``), or the plain exact int32
product.  The expert-parallel all-to-all body (``moe_ffn_a2a``) belongs to
the distributed slice.

Capacity ``max(int(T * k * capacity_factor / E), 1)`` counts every token
of the call, pad and inactive rows included, so a token's output depends
on the other tokens in its call (the reference's own behaviour).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.api import QuantConfig, dense
from repro_torch.layers.mlp import mlp, silu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False   # llama4-style always-on expert


def dense_expert(x, p: dict, cfg: QuantConfig | None):
    """Batched per-expert linear: x (E, C, din) @ w (E, din, dout)."""
    b = p.get("b")
    if cfg is None or cfg.mode == "float":
        y = torch.matmul(x, p["w"])
    elif cfg.mode == "fake":
        w = p["w"]
        dw = quant.absmax_scale(w, cfg.w_bits, axis=1)       # (E,1,dout)
        w_fq = quant.fake_quant(w, dw, cfg.w_bits)
        dx = quant.absmax_scale(x, cfg.a_bits)
        x_fq = quant.fake_quant(x, dx, cfg.a_bits)
        y = torch.matmul(x_fq, w_fq)
    elif cfg.mode == "int":
        from repro_torch.kernels.dispatch import maybe_qexpert
        y = maybe_qexpert(x, p, cfg)       # cuda backend; None -> plain path
        if y is None:
            xq = quant.quantize_tensor(x, cfg.a_bits)
            acc = quant.int_matmul_exact(xq.q, p["w_q"])
            y = acc.to(torch.float32) * (xq.scale * p["w_scale"])
            y = y.to(x.dtype)
    else:
        raise ValueError(f"unknown quant mode {cfg.mode!r}")
    return y + b[:, None, :] if b is not None else y


def route(x, p: dict, mcfg: MoEConfig):
    """The router, in float: (probs (T, E) f32, gate (T, k) renormalised,
    idx (T, k)).  Ties go to the lower expert id, as ``jax.lax.top_k``
    breaks them (a stable descending sort)."""
    logits = dense(x, p["router"], None).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :mcfg.top_k], idx[:, :mcfg.top_k]
    return probs, gate / gate.sum(dim=-1, keepdim=True), idx


def _assign_slots(x, gate, idx, e, cap):
    """Token->(expert, slot) assignment with capacity dropping.

    Returns (buf, eid, slot, keepw): buf (E, cap, d) dispatched tokens.
    """
    t, d = x.shape
    k = idx.shape[1]
    flat_oh = F.one_hot(idx.reshape(t * k), e)                # (T*k, E)
    pos = torch.cumsum(flat_oh, dim=0) - flat_oh              # slots before me
    pos = (pos * flat_oh).sum(dim=-1)                         # (T*k,)
    eid = idx.reshape(t * k)
    keep = (pos < cap).to(x.dtype)
    slot = torch.clamp(pos, max=cap - 1)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    # each token's k choices in place (jnp.repeat), not the tensor tiled
    buf.index_put_((eid, slot),
                   torch.repeat_interleave(x, k, dim=0) * keep[:, None],
                   accumulate=True)
    keepw = (gate.reshape(t * k) * keep)[:, None]
    return buf, eid, slot, keepw


def _expert_stack(buf, p, cfg, act):
    """gate/up/down expert FFN on a (E, C, d) buffer."""
    h_gate = silu(dense_expert(buf, p["experts_gate"], cfg)) \
        if act == "swiglu" else None
    h = dense_expert(buf, p["experts_up"], cfg)
    h = (h_gate * h) if h_gate is not None else F.gelu(h, approximate="tanh")
    return dense_expert(h.to(buf.dtype), p["experts_down"], cfg)


def moe_ffn(x, p: dict, mcfg: MoEConfig, cfg: QuantConfig | None, *,
            act: str = "swiglu"):
    """x: (T, d) flat tokens -> (T, d), plus aux dict (load-balance loss).

    The output is f32 where ``x`` is bf16 (the gate weights are f32), as
    in the reference; the caller casts it back."""
    t, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    cap = max(int(t * k * mcfg.capacity_factor / e), 1)
    probs, gate, idx = route(x, p, mcfg)
    buf, eid, slot, keepw = _assign_slots(x, gate, idx, e, cap)
    out_buf = _expert_stack(buf, p, cfg, act)                 # (E, cap, d)
    picked = out_buf[eid, slot]                               # (T*k, d)
    out = (picked * keepw).reshape(t, k, d).sum(dim=1)
    if mcfg.shared_expert:
        out = out + mlp(x, p["shared"], cfg, act=act)
    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e.
    frac = F.one_hot(idx[:, 0], e).to(torch.float32).mean(dim=0)
    aux = {"lb_loss": e * torch.sum(frac * probs.mean(dim=0))}
    return out, aux


def init_moe(gen: torch.Generator, d: int, ff: int, mcfg: MoEConfig, *,
             act: str = "swiglu", dtype=torch.bfloat16, lead=(),
             device="cuda") -> dict:
    """Random router, expert and shared-expert weights from ``gen`` on
    ``device`` (``lead``: stacked layer axes), the reference's keys and
    layouts: router ``(d, E)``, experts ``(E, din, dout)``."""
    e = mcfg.n_experts

    def w(*shape):
        t = torch.randn((*lead, *shape), generator=gen, device=device)
        return {"w": t.mul_(shape[-2] ** -0.5).to(dtype)}

    p = {"router": w(d, e), "experts_up": w(e, d, ff),
         "experts_down": w(e, ff, d)}
    if act == "swiglu":
        p["experts_gate"] = w(e, d, ff)
    if mcfg.shared_expert:
        p["shared"] = {"up": w(d, ff), "down": w(ff, d)}
        if act == "swiglu":
            p["shared"]["gate"] = w(d, ff)
    return p
