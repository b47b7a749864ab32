"""Mixture-of-Experts FFN: top-k routing, capacity dispatch — in PyTorch.

Counterpart of ``repro/layers/moe.py``, single-device body: token slots
are assigned with a cumulative count over expert ids, tokens beyond an
expert's capacity are dropped (weight zero), and the expert FFNs run as
batched ``(E, C, d)`` contractions through :func:`dense_expert`, so the
paper's reordering applies to MoE unchanged.  In ``int`` mode the expert
products take the qmatmul kernel, one launch an expert
(``kernels/dispatch.py::maybe_qexpert``), or the plain exact int32
product.  Under sharding rules with ``moe_a2a`` on a mesh with a "model"
axis, :func:`moe_ffn` takes the expert-parallel body :func:`moe_ffn_a2a`
with its explicit all-to-all exchanges, on global tensors or, under
partitioned rules, on the rank's tokens and experts; where a rank's
tokens do not split over "model" it falls back to the dense dispatch, as
the reference does.

Capacity ``max(int(T * k * capacity_factor / E), 1)`` counts every token
of the call, pad and inactive rows included, so a token's output depends
on the other tokens in its call (the reference's own behaviour); the
all-to-all body counts the rank's token sub-shard instead (``cap_sub``),
so the tokens it drops are not the dense dispatch's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.core import quant
from repro_torch.core.api import QuantConfig, dense
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import current_rules, shard
from repro_torch.layers.mlp import mlp, silu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False   # llama4-style always-on expert


def dense_expert(x, p: dict, cfg: QuantConfig | None, *,
                 split: bool = False):
    """Batched per-expert linear: x (E, C, din) @ w (E, din, dout).
    ``split``: under partitioned rules x and w hold this rank's experts of
    the dense dispatch, and the activation grid spans every rank's (else
    it is the buffer's own, as in the all-to-all body)."""
    b = p.get("b")
    if cfg is None or cfg.mode == "float":
        y = torch.matmul(x, p["w"])
    elif cfg.mode == "fake":
        w = p["w"]
        dw = quant.absmax_scale(w, cfg.w_bits, axis=1)       # (E,1,dout)
        w_fq = quant.fake_quant(w, dw, cfg.w_bits)
        dx = quant.absmax_scale(x, cfg.a_bits,
                                group=partition.heads_max if split else None)
        x_fq = quant.fake_quant(x, dx, cfg.a_bits)
        y = torch.matmul(x_fq, w_fq)
    elif cfg.mode == "int":
        from repro_torch.kernels.dispatch import maybe_qexpert
        group = partition.heads_max if split else None
        y = maybe_qexpert(x, p, cfg, group)  # cuda backend; None -> plain
        if y is None:
            xq = quant.quantize_tensor(x, cfg.a_bits, group=group)
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


def _expert_stack(buf, p, cfg, act, split=False):
    """gate/up/down expert FFN on a (E, C, d) buffer (``split``: as
    :func:`dense_expert`'s)."""
    h_gate = silu(dense_expert(buf, p["experts_gate"], cfg, split=split)) \
        if act == "swiglu" else None
    h = dense_expert(buf, p["experts_up"], cfg, split=split)
    h = (h_gate * h) if h_gate is not None else F.gelu(h, approximate="tanh")
    return dense_expert(h.to(buf.dtype), p["experts_down"], cfg, split=split)


def _local_experts(p, name, lo, hi, mesh, fsdp):
    """Experts [lo, hi) of the global ``p[name]`` as this rank's expert
    stack; with ``fsdp`` the rank's dout slice over "data", gathered back in
    its storage dtype (bf16 weights, int8 codes and their scales)."""
    from repro_torch.distributed import collectives as col
    out = {}
    for key in ("w", "w_q", "w_scale"):
        if key not in p[name]:
            continue
        w = p[name][key][lo:hi]
        if fsdp:
            n, i = col.axes_size(mesh, ("data",)), col.axes_index(mesh,
                                                                  ("data",))
            cols = w.shape[2] // n
            w = w[:, :, i * cols:(i + 1) * cols].transpose(0, 2)
            w = col.gather0(w, col.group(mesh, "data"),
                            shards=True).transpose(0, 2)
        out[key] = w
    return out


def _expert_names(act):
    return ("experts_gate", "experts_up", "experts_down") \
        if act == "swiglu" else ("experts_up", "experts_down")


def _fsdp_experts(p, part):
    """``p`` with the rank's experts' dout gathered over "data" where
    ``expert_fsdp`` splits it (in their storage dtype; the backward
    reduce-scatters, since each data rank uses them on its own tokens)."""
    if part is None or not part.layout.fsdp:
        return p
    return {name: ({key: part.gather(w, ("data",), -1, shards=True)
                    for key, w in lin.items()}
                   if name.startswith("experts_") else lin)
            for name, lin in p.items()}


def _shared_expert(x, p, cfg, act):
    """The shared expert on ``x``; under partitioned rules its feed-forward
    holds the rank's columns where it is narrower than the experts'."""
    split = partition.out_features(p["shared"]["up"]) < \
        _lead(p["experts_up"]).shape[-1]
    return mlp(x, p["shared"], cfg, act=act, k_split=split)


def _a2a_body(xs, router, experts, mcfg, cfg, act, model, m):
    """The reference's ``shard_map`` body on one rank: its token sub-shard
    ``xs`` (ts, d), routed in float by ``router`` into ``cap_sub`` slots,
    sent to the experts' owners by an all-to-all over ``model`` (the
    sources' slots concatenated: ``(E/m, m * cap_sub, d)``), through its
    E/m ``experts`` (``int``: ``dispatch.maybe_qexpert`` on the buffer's
    own grid), back by the reverse all-to-all and combined.  Returns
    (y_sub (ts, d), this rank's ``lb_loss`` term)."""
    from repro_torch.distributed import collectives as col
    e, k = mcfg.n_experts, mcfg.top_k
    ts = xs.shape[0]
    cap_sub = max(int(ts * k * mcfg.capacity_factor / e), 1)
    probs, gate, idx = route(xs, {"router": router}, mcfg)
    buf, eid, slot, keepw = _assign_slots(xs, gate, idx, e, cap_sub)
    e_loc = e // m
    # experts -> their owning rank; sources' slots concatenate (tiled a2a
    # with split_axis 0, concat_axis 1)
    buf = col.all_to_all0(buf, model)                   # (m*E_loc, cap, d)
    buf = buf.reshape(m, e_loc, cap_sub, -1).transpose(0, 1).reshape(
        e_loc, m * cap_sub, -1)
    out_buf = _expert_stack(buf, experts, cfg, act)     # (E_loc, m*cap, d)
    out_buf = out_buf.reshape(e_loc, m, cap_sub, -1).transpose(0, 1)
    out_buf = col.all_to_all0(out_buf, model).reshape(e, cap_sub, -1)
    picked = out_buf[eid, slot]
    y_sub = (picked * keepw).reshape(ts, k, -1).sum(dim=1)
    frac = F.one_hot(idx[:, 0], e).to(torch.float32).mean(dim=0)
    return y_sub, e * torch.sum(frac * probs.mean(dim=0))


def moe_ffn_a2a(x, p, mcfg: MoEConfig, cfg: QuantConfig | None, rules, *,
                act: str = "swiglu"):
    """Expert-parallel MoE with an EXPLICIT all-to-all dispatch: the
    reference's ``shard_map`` body (:func:`_a2a_body`) on each rank of the
    mesh:

      its token sub-shard over "model" of its batch rows  (no exchange)
        -> top-k routing + capacity slots (``cap_sub``)  (no exchange)
        -> all-to-all over "model": experts to owners  (E_loc, m*cap_sub, d)
        -> [``expert_fsdp``: gather the expert weights' dout over "data",
           in their storage dtype]
        -> the rank's E/m experts (``int``: one qmatmul launch an expert)
        -> reverse all-to-all + combine              (cap_sub slots back)
        -> all-gather of ``y_sub`` in ``x.dtype`` over "model".

    Under partitioned rules (``distributed/partition.py``) ``x`` holds the
    rank's batch rows, alike over "model", and ``p`` the rank's E/m
    experts (their dout split over "data" with ``expert_fsdp``) and the
    whole router; the result is the rank's rows, and every step carries
    its gradient through ``Partition``'s exchanges: the sub-shard's
    backward gathers over "model", the router's sums over "model", the
    all-to-alls' are the reverse exchanges, the gather's hands each rank
    its chunk.  On global tensors (rules without ``partitioned``) every
    rank takes its rows, sub-shard and experts of them (each entering
    through ``col.shared_input``, so every rank ends with the full
    gradients) and the rows are gathered back over the batch axes.

    ``lb_loss`` is the mean over the mesh of each rank's.  Requires
    ``n_experts % m == 0``.  Returns ``x.dtype`` (the dense dispatch
    returns f32 for bf16 x, as the reference's two bodies do).
    """
    from repro_torch.distributed import collectives as col
    mesh = rules.mesh
    m = col.axes_size(mesh, ("model",))
    e = mcfg.n_experts
    model = col.group(mesh, "model")
    part = partition.active()
    if part is not None:
        if e % m or x.shape[0] % m:
            raise ValueError(f"moe_ffn_a2a: {e} experts, {x.shape[0]} "
                             f"tokens over {m} model ranks")
        p = _fsdp_experts(p, part)
        router = {k: part.shared(v) for k, v in p["router"].items()}
        y_sub, lb = _a2a_body(part.take(x, ("model",)), router,
                              {name: p[name] for name in _expert_names(act)},
                              mcfg, cfg, act, model, m)
        y = part.gather(y_sub.to(x.dtype), ("model",))
        lb = part.mean(lb, ("model",) + part.batch)
    else:
        bax = tuple(a for a in rules.batch if a in mesh.mesh_dim_names)
        n_dp = col.axes_size(mesh, bax)
        if e % m or x.shape[0] % (n_dp * m):
            raise ValueError(f"moe_ffn_a2a: {e} experts, {x.shape[0]} "
                             f"tokens over {n_dp} batch x {m} model ranks")
        t_local = x.shape[0] // n_dp
        ts = t_local // m                    # token sub-shard per model rank
        j = col.axes_index(mesh, ("model",))
        fsdp = rules.expert_fsdp and "data" in mesh.mesh_dim_names
        # every rank takes its own tokens and experts of the global tensors
        ranks = bax + ("model",)
        p = {k: (v if k == "shared" else tree_lib.tree_map(
            lambda t: col.shared_input(t, mesh, ranks), v))
            for k, v in p.items()}
        start = col.axes_index(mesh, bax) * t_local + j * ts
        xs = col.shared_input(x, mesh, ranks)[start:start + ts]
        e_loc = e // m
        lp = {name: _local_experts(p, name, j * e_loc, (j + 1) * e_loc, mesh,
                                   fsdp) for name in _expert_names(act)}
        y_sub, lb = _a2a_body(xs, p["router"], lp, mcfg, cfg, act, model, m)
        y = col.gather_axes(col.gather0(y_sub.to(x.dtype), model), mesh, bax)
        for a in ("model",) + bax:
            lb = col.mean(lb, col.group(mesh, a))
    if mcfg.shared_expert:
        y = y + _shared_expert(x, p, cfg, act)
    return y, {"lb_loss": lb}


def _lead(lin):
    return lin["w_q"] if "w_q" in lin else lin["w"]


def moe_ffn(x, p: dict, mcfg: MoEConfig, cfg: QuantConfig | None, *,
            act: str = "swiglu"):
    """x: (T, d) flat tokens -> (T, d), plus aux dict (load-balance loss).

    The output is f32 where ``x`` is bf16 (the gate weights are f32), as
    in the reference; the caller casts it back.  Under rules with
    ``moe_a2a`` on a mesh with a "model" axis the expert-parallel body
    :func:`moe_ffn_a2a` runs instead where E splits over "model" and the
    tokens of a rank's rows sub-shard over it; else (decode-sized blocks)
    the dense dispatch runs, as in the reference.

    Under partitioned rules ``x`` holds the rank's tokens and ``p`` its
    experts (E/m where E splits over "model"; with ``expert_fsdp`` their
    dout split over "data", gathered here).  The dense dispatch then
    routes and assigns the capacity slots over all of the call's tokens,
    gathered over the batch axes since the capacity couples them; the
    rank runs only its experts (on a grid over every rank's buffer), their
    outputs are gathered along E, the combine runs as on one rank and the
    rank keeps its own tokens, on which the shared expert runs.  Bit for
    bit one rank's run in int mode.  The gathers carry gradients
    (``distributed/partition.py``): the tokens' and the experts' weights'
    reduce-scatter, since each batch rank keeps the gradient of its own
    tokens' outputs only; the expert buffer's slice gathers its gradient
    back over "model"."""
    part = partition.active()
    rules = current_rules()
    if (rules is not None and rules.moe_a2a and rules.mesh is not None
            and "model" in rules.mesh.mesh_dim_names):
        from repro_torch.distributed import collectives as col
        mesh = rules.mesh
        m = col.axes_size(mesh, ("model",))
        n_dp = 1 if part is not None else col.axes_size(mesh, tuple(
            a for a in rules.batch if a in mesh.mesh_dim_names))
        t_loc = x.shape[0] // n_dp                 # the rank's tokens
        if mcfg.n_experts % m == 0 and t_loc % m == 0 and t_loc > 0:
            return moe_ffn_a2a(x, p, mcfg, cfg, rules, act=act)
    xg = x if part is None else part.gather(x, part.batch, shards=True)
    t, d = xg.shape
    e, k = mcfg.n_experts, mcfg.top_k
    cap = max(int(t * k * mcfg.capacity_factor / e), 1)
    probs, gate, idx = route(xg, p, mcfg)
    buf, eid, slot, keepw = _assign_slots(xg, gate, idx, e, cap)
    buf = shard(buf, "expert", None, None)
    e_loc = _lead(p["experts_up"]).shape[0]
    p = _fsdp_experts(p, part)
    if e_loc != e:                            # this rank's experts only
        buf = part.take(buf, ("model",))
    out_buf = _expert_stack(buf, p, cfg, act, e_loc != e)     # (E, cap, d)
    if e_loc != e:
        out_buf = part.gather(out_buf, ("model",))
    out_buf = shard(out_buf, "expert", None, None)
    picked = out_buf[eid, slot]                               # (T*k, d)
    out = (picked * keepw).reshape(t, k, d).sum(dim=1)
    if part is not None:
        out = part.batch_rows(out)
    if mcfg.shared_expert:
        out = out + _shared_expert(x, p, cfg, act)
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
