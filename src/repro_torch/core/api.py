"""Quantization/integerization as a model feature, in PyTorch.

Counterpart of ``repro/core/api.py``.  Modes of :class:`QuantConfig`:

- ``"float"``: full-precision reference;
- ``"fake"``: the QAT (training) graph — fake quantization
  (:func:`repro_torch.core.quant.fake_quant`, STE and LSQ gradients) of
  weights per output column and of activations per tensor, float matmuls;
- ``"int"``: the paper's integerized serving graph — int8 weight codes,
  activations quantized at module inputs, integer contractions with the
  dequantization reordered into a per-channel epilogue (Eq. 2).

Param-tree convention (identical to the JAX package): a sub-dict
``{"w": (in, out) float, ["b": (out,)]}`` is a linear layer;
:func:`integerize_params` rewrites it to
``{"w_q": (out, in) int8, "w_scale": (out,), ["b"]}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import integerize, quant
from repro_torch.core.integerize import QLinearParams
from repro_torch.core.quant import QTensor


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    w_bits: int = 4
    a_bits: int = 8
    attn_bits: int = 8          # attention-probability grid (unsigned)
    kv_bits: int = 8            # serving KV-cache storage
    mode: str = "fake"          # "float" | "fake" | "int"
    softmax: str = "base2"      # "base2" (paper Eq.4) | "exact" (ablation)
    quantize_embeddings: bool = True
    pack_weights: bool = False  # pack 2x4b per byte (kernels unpack)
    backend: Optional[str] = None   # "cuda" | "torch" | None (process
    #                                 default: see kernels.dispatch)

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


FLOAT = QuantConfig(mode="float")


def is_linear(p: Any) -> bool:
    return (isinstance(p, dict)
            and (("w" in p and getattr(p["w"], "ndim", 0) == 2)
                 or ("w_q" in p)))


def dense(x: torch.Tensor, p: dict, cfg: Optional[QuantConfig], *,
          tp: Optional[str] = None, k_split: bool = False,
          seq: bool = False) -> torch.Tensor:
    """The one linear-layer entry point of the models.

    ``tp="row"`` marks the reference's row-parallel layers (wo, down, the
    RG-LRU's w_out): when the active sharding rules enable
    ``int_bf16_reduce`` on a mesh with a "model" axis, their integerized
    form runs the shard body :func:`_int_row_parallel`, whose cross-rank
    reduce moves bf16, on global tensors (every rank slices its operands
    out) or, under partitioned rules, on the rank's own rows and K slice.
    Otherwise, under partitioned rules, ``tp="row"`` and ``tp="sum"`` (a
    product the reference leaves unmarked, whose GSPMD program sums the
    heads' partial products all the same: Whisper's decode self-attention
    wo) run ``distributed/partition.py::row_parallel_linear``, whose int32
    sums are all-reduced over "model" where ``k_split`` says x and the
    codes hold this rank's slice of K.

    Under partitioned rules the float and fake forms take ``x``'s rows of
    the rank (the per-tensor activation grid maxed over the batch axes)
    and, with ``tp`` and ``k_split``, its slice of K: both grids then max
    over "model" too, and the partial products are summed over "model"
    (``Partition.sum``) before the bias.

    ``seq`` (a row-parallel product under the residual's sequence split,
    ``partition.seq_split``; x (B, S, K) whole in S): the result is this
    rank's chunk of the sequence, the partial products reduce-scattered
    along S where they split (int32 sums in int mode, f32 in the float
    and fake modes: ``Partition.scatter``) instead of all-reduced, else
    narrowed to the chunk; the bias is added on the rank's rows.
    """
    from repro_torch.distributed import partition
    b = p.get("b")
    split = tp in ("row", "sum") and k_split and \
        partition.active() is not None
    if cfg is None or cfg.mode == "float":
        y = _reduce(_matmul(x, p["w"]), split, seq)
        return y + b if b is not None else y
    if cfg.mode == "fake":
        w = p["w"]
        dw = quant.absmax_scale(w, cfg.w_bits, axis=0,          # per-out-col
                                group=partition.heads_max if split else None)
        w_fq = quant.fake_quant(w, dw, cfg.w_bits)
        dx = quant.absmax_scale(x, cfg.a_bits, group=partition.tensor_max
                                if split else partition.rows_max)
        x_fq = quant.fake_quant(x, dx, cfg.a_bits)
        y = _reduce(_matmul(x_fq, w_fq), split, seq)
        return y + b if b is not None else y
    if cfg.mode == "int":
        from repro_torch.distributed.sharding import current_rules
        rules = current_rules()
        if (tp == "row" and rules is not None and rules.int_bf16_reduce
                and rules.mesh is not None
                and "model" in rules.mesh.mesh_dim_names):
            return _int_row_parallel(x, p, cfg, rules, k_split)
        if tp in ("row", "sum") and partition.active() is not None:
            return partition.row_parallel_linear(x, p, cfg, k_split, seq)
        from repro_torch.kernels.dispatch import maybe_qlinear
        y = maybe_qlinear(x, p, cfg)       # cuda backend; None -> plain path
        if y is not None:
            return y
        if x.ndim == 3:
            # (B, S, K) serving activations calibrate per sequence: one hot
            # row never coarsens another sequence's grid, and a batched
            # admission prefill is bit-identical per row to a solo run.
            dx = quant.absmax_scale(x, cfg.a_bits, axis=(1, 2))
            xq = quant.quantize_tensor(x, cfg.a_bits, scale=dx)
        else:
            xq = quant.quantize_tensor(x, cfg.a_bits,
                                       group=partition.tensor_max)
        return integerize.int_linear(xq, as_qlinear(p, cfg)).to(x.dtype)
    raise ValueError(f"unknown quant mode {cfg.mode!r}")


def _reduce(y, split, seq):
    """The float partial products ``y`` (B, S, N) of a row-parallel
    product: summed over "model" where K ``split``; with ``seq`` this
    rank's chunk of S of the sum (a reduce-scatter), or of ``y``."""
    from repro_torch.distributed import partition
    if split:
        part = partition.active()
        return part.scatter(y, ("model",), 1) if seq else part.sum(y)
    return partition.seq_rows(y, seq)


def _matmul(x, w):
    """``x @ w`` in their promoted type, as ``jnp.matmul`` takes mixed
    operands (the SSD's f32 normed output into a bf16 ``out_proj``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def _int_row_parallel(x, p, cfg, rules, k_split=False):
    """Row-parallel integer linear with an explicit bf16 cross-rank reduce:
    the reference's ``shard_map`` body, on this rank's operands.

    Under partitioned rules (``distributed/partition.py``) ``x`` holds the
    rank's batch rows and, with ``k_split``, its slice of K, and ``w_q``
    the same K slice as stored (nibble bytes included); where the tree
    keeps K whole on the rank (``k_split`` False), the body takes the
    rank's K slice of both per call, as the reference's ``shard_map``
    does.  The result is the rank's rows.  On global tensors (rules
    without ``partitioned``) every rank takes its batch rows and K slice
    of ``x``, and of ``w_q`` a copy kept with the codes
    (``dispatch.row_codes``), and the rows are gathered back over the
    batch axes, since the model code holds global tensors there.

    The body (:func:`_row_body`) is the same either way, so both are
    bitwise equal on the same mesh.  The f32 partials sum in the
    collective's order, not XLA's: past two ranks a bf16 result may differ
    from the reference's by one bf16 ulp at a rounding edge.
    """
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import partition
    from repro_torch.kernels.dispatch import row_codes
    mesh = rules.mesh
    m, j = col.axes_size(mesh, ("model",)), col.axes_index(mesh, ("model",))
    w_q = p["w_q"]
    packed = w_q.dtype == torch.uint8
    if partition.active() is not None:
        if k_split:
            _row_divides(x, w_q, 1, m, 1, packed)
            return _row_body(x, w_q, p, cfg, mesh, m)
        _row_divides(x, w_q, 1, m, m, packed)
        kl = x.shape[-1] // m
        unit = kl // 2 if packed else kl
        w = w_q[:, j * unit:(j + 1) * unit].contiguous()
        return _row_body(x[..., j * kl:(j + 1) * kl], w, p, cfg, mesh, m)
    bax = tuple(a for a in rules.batch if a in mesh.mesh_dim_names)
    n_dp, bi = col.axes_size(mesh, bax), col.axes_index(mesh, bax)
    _row_divides(x, w_q, n_dp, m, m, packed)
    bl, kl = x.shape[0] // n_dp, x.shape[-1] // m
    xl = x[bi * bl:(bi + 1) * bl, ..., j * kl:(j + 1) * kl]
    y = _row_body(xl, row_codes(w_q, j, m), p, cfg, mesh, m)
    return col.gather_axes(y, mesh, bax)


def _row_divides(x, w_q, n_dp, m, k_parts, packed):
    """Raise unless x's rows split over ``n_dp`` batch ranks, the output
    columns over ``m`` model ranks (the reduce-scatter) and x's K into
    ``k_parts`` slices (nibble-packed codes: even ones)."""
    n, kdim = w_q.shape[0], x.shape[-1]
    if x.shape[0] % n_dp or n % m or kdim % k_parts or \
            (packed and (kdim // k_parts) % 2):
        raise ValueError(f"row-parallel linear: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)} over {n_dp} batch x {m} model "
                         f"ranks (packed K slices must be even)")


def _row_body(xl, w, p, cfg, mesh, m):
    """The rank's part of :func:`_int_row_parallel`: ``xl`` (..., K/m) on
    ONE per-tensor grid of its own (3-D x too: no grid per sequence, no
    exchange), its int32 partial product against ``w`` (N, K/m) int8 or
    (N, K/2m) nibbles, contiguous, with the f32 epilogue ``f32(acc) *
    (w_scale * x_scale)`` and no bias (on the ``cuda`` backend the qmatmul
    kernel: ``dispatch.maybe_qlinear_row``), the f32 partials
    reduce-scattered over "model" by output column, each rank's 1/m of the
    sum cast to bf16 and all-gathered in 2-byte lanes, cast to
    ``xl.dtype`` and the bias added once."""
    from repro_torch.distributed import collectives as col
    from repro_torch.kernels.dispatch import maybe_qlinear_row
    model = col.group(mesh, "model")
    n, kl = w.shape[0], xl.shape[-1]
    xq = quant.quantize_tensor(xl, cfg.a_bits)
    codes = xq.q.reshape(-1, kl)
    scale = (p["w_scale"] * xq.scale).to(torch.float32)
    y = maybe_qlinear_row(codes, w, scale, cfg)
    if y is None:
        wu = quant.unpack_int4(w) if w.dtype == torch.uint8 else w
        acc = quant.int_matmul_exact(codes, wu.T)
        y = acc.to(torch.float32) * scale
    rows = codes.shape[0]
    # psum_scatter over the last dim: rank r keeps columns [r*N/m, ...)
    y = col.reduce_scatter0(y.reshape(rows, m, n // m).transpose(0, 1), model)
    y = col.gather0(y.to(torch.bfloat16), model)            # 2-byte lanes
    y = y.reshape(m, rows, n // m).transpose(0, 1).reshape(*xl.shape[:-1], n)
    y = y.to(xl.dtype)
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def as_qlinear(p: dict, cfg: QuantConfig) -> QLinearParams:
    w_q = p["w_q"]
    if w_q.dtype == torch.uint8:           # nibble-packed storage
        w_q = quant.unpack_int4(w_q)
    return QLinearParams(w_q=w_q, w_scale=p["w_scale"], bias=p.get("b"),
                         w_bits=cfg.w_bits)


def dense_q(x: QTensor, p: dict, cfg: QuantConfig, *,
            apply_input_scale: bool = True) -> torch.Tensor:
    """Integer linear on an already-quantized activation."""
    return integerize.int_linear(x, as_qlinear(p, cfg),
                                 apply_input_scale=apply_input_scale)


# Expert-batched weights keep their (E, din, dout) layout; these parents
# stay float (router precision, rglru gates: the paper's "cheap ops" rule).
EXPERT_PARENTS = frozenset({"experts_up", "experts_gate", "experts_down"})
FLOAT_PARENTS = frozenset({"router", "w_a", "w_i", "head"})
# row-parallel linears: K split over "model" under partitioned rules (the
# RG-LRU's w_out over d_rnn)
ROW_PARENTS = frozenset({"wo", "down", "w_out"})


def integerize_params(params: Any, cfg: QuantConfig) -> Any:
    """Rewrite every linear's float weight into reordered integer form.

    Handles layer-stacked weights ((U, in, out)) and expert-batched weights
    ((E, din, dout), possibly stacked) by layout.  Embeddings become
    per-row int8 codes when ``cfg.quantize_embeddings``.  Returns a new
    tree; float weights of the input are not modified.

    Under partitioned rules ``params`` is this rank's tree
    (``distributed/partition.py``) and so is the result: a row-parallel
    weight's per-column grid spans the whole K (its max taken over
    "model"), and experts split over "data" (``expert_fsdp``) are
    gathered back whole, codes and scales, for serving.  So it equals the
    partition of the global tree's integerization, bit for bit.
    """
    from repro_torch.distributed import partition
    part = partition.active()

    def q_linear(w, row):
        # (..., in, out) -> codes (..., out, in), scale (..., out)
        wt = w.to(torch.float32).transpose(-1, -2)
        dw = quant.absmax_scale(wt, cfg.w_bits, axis=-1,       # (...,out,1)
                                group=partition.heads_max if row else None)
        return quant.quantize(wt, dw, cfg.w_bits).contiguous(), dw[..., 0]

    def q_expert(w):
        # (..., E, din, dout) -> codes same layout, scale (..., E, 1, dout);
        # never nibble-packed
        w = w.to(torch.float32)
        dw = quant.absmax_scale(w, cfg.w_bits, axis=-2)
        q = quant.quantize(w, dw, cfg.w_bits)
        if part is not None and part.layout.fsdp:
            q, dw = (part.gather(t, ("data",), -1) for t in (q, dw))
        return q, dw

    def rewrite(p, parent=""):
        if not isinstance(p, dict):
            return p
        if "w" in p and parent not in FLOAT_PARENTS:
            new = {k: rewrite(v, k) for k, v in p.items() if k != "w"}
            if parent in EXPERT_PARENTS:
                new["w_q"], new["w_scale"] = q_expert(p["w"])
                return new
            wq, dw = q_linear(p["w"], part is not None
                              and parent in ROW_PARENTS)
            if cfg.pack_weights and cfg.w_bits == 4 and wq.shape[-1] % 2 == 0:
                new["w_q"] = quant.pack_int4(wq)   # uint8 marks packing
            else:
                new["w_q"] = wq
            new["w_scale"] = dw
            return new
        if "emb" in p and cfg.quantize_embeddings:
            emb = p["emb"].to(torch.float32)
            de = quant.absmax_scale(emb, 8, axis=1)               # per-row
            new = {k: rewrite(v, k) for k, v in p.items() if k != "emb"}
            new["emb_q"] = quant.quantize(emb, de, 8)
            new["emb_scale"] = de[:, 0]
            return new
        return {k: rewrite(v, k) for k, v in p.items()}

    return rewrite(params)


def _leaves(tree, name=""):
    """(key, tensor) for every tensor leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, str(k))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, name)
    elif isinstance(tree, torch.Tensor):
        yield name, tree


def count_params(params: Any) -> int:
    return sum(leaf.numel() for _, leaf in _leaves(params))


def model_bytes(params: Any, cfg: Optional[QuantConfig]) -> int:
    """Storage accounting with *logical* bit widths (paper Table II), by
    the reference's rule on each leaf's key."""
    total_bits = 0
    for name, leaf in _leaves(params):
        if "w_q" in name or ("w" in name and leaf.ndim in (2, 3)):
            bits = cfg.w_bits if cfg else 32
        elif "emb" in name:
            bits = 8 if (cfg and cfg.quantize_embeddings) else 32
        else:
            bits = 32
        total_bits += leaf.numel() * bits
    return total_bits // 8
