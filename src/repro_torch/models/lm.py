"""Decoder-only LM (attention, local attention, RG-LRU and SSD blocks) with
the ring and the paged KV caches — in PyTorch.

Counterpart of ``repro/models/lm.py`` for the serving paths:
:class:`LMConfig`, :func:`init_params`, :func:`forward`, :func:`logits_fn`,
the ring cache (:func:`init_cache`, :func:`prefill`, :func:`decode_step`)
and the paged cache (:func:`init_paged_cache`, :func:`paged_prefill`,
:func:`admission_prefill`, :func:`decode_step`, :func:`copy_page`,
:func:`page_scale_pools`), with dense or MoE feed-forwards
(``cfg.moe``: :func:`repro_torch.layers.moe.moe_ffn` on the flattened
``(B*S, d)`` tokens) and the patch frontend (``cfg.frontend == "patch"``:
``batch["patches"]`` (B, n_patches, d) prepended to the token embeddings,
so positions and ``pos`` count them; the ring path takes them, the paged
engine serves text).  The recurrent blocks (``"rglru"``:
:func:`repro_torch.layers.rglru.rglru_block`, ``"ssd"``:
:func:`repro_torch.layers.ssd.ssd_block`) keep their states per row, in
the ring cache and beside the page pools of the paged cache alike; they
start from a zero state at (every chunk of) a prefill and from the row's
state at decode, as the reference's do.  Training: :func:`lm_loss` (the
causal LM loss, sequence-chunked, plus 0.01 x the MoE load-balance loss
that :func:`forward` sums into ``aux``), through autograd, with each
pattern unit recomputed in the backward pass when ``cfg.remat``
(``torch.utils.checkpoint``; only with grad enabled and no cache, so an
in-place cache write is never recomputed).

Parameters and caches are plain dicts of tensors with the JAX package's
keys and layouts: linear weights ``(in, out)`` float or ``w_q (out, in)``
int8 codes, layer-stacked ``units`` subtrees (leading layer axis; the
reference's scan over units is a Python loop here).

- Ring cache: an attention layer keeps ``k``/``v`` ``(B, Hkv, span, hd)``
  int8 codes (``hd/2`` uint8 nibbles at ``kv_bits=4``, floats in float
  mode), one per-tensor ``k_scale``/``v_scale`` per layer calibrated at
  prefill, and a 0-d ``pos`` shared by the batch; position ``p`` lives in
  slot ``p % span`` (``span = max_len``, or ``window + q_chunk`` for
  ``local`` layers); an ``rglru`` layer keeps ``h (B, d_rnn)`` and
  ``conv (B, 3, d_rnn)``, an ``ssd`` layer ``h (B, H, P, N)`` and ``convs
  (B, 3, d_conv)``, all f32.  ``pos`` stays on the device: a decode step
  never reads it on the host.
- Paged cache: pools ``(num_pages + 1, Hkv, page_size, hd[/2])`` whose
  last page is the TRASH page (masked writes land there, it is never
  read), ``pos (B,)`` (negative = inactive row) and ``page_table
  (B, max_pages)`` (negative = unallocated).  Scales calibrate per
  sequence ``(B,)`` and are read per PHYSICAL page
  (``page_k_scale``/``page_v_scale``), so a page aliased from a shared
  prefix dequantizes with its owner's grid.  A recurrent layer keeps its
  ring-cache state, one row per sequence: a decode step updates every
  row's, inactive rows' included, and an admission's install overwrites
  the admitted rows'.

Where JAX returned updated copies, this port writes in place:

- :func:`decode_step` writes the new key/value into the ring slot (or
  each row's page of the pools), and advances ``cache["pos"]``, in place;
- :func:`prefill` fills the ring it creates (codes, scales, recurrent
  states, ``pos``), and a decode step writes each recurrent state;
- :func:`paged_prefill` writes the prompt's codes into the pools, the
  per-sequence scales, the per-page scale registrations and ``pos`` in
  place;
- :func:`admission_prefill` writes codes and page scales straight into the
  serving cache's shared pools and installs per-row leaves at ``rows``;
- :func:`copy_page` copies one physical page into another in place.

Each returns the cache it was given, so callers read like the reference.
Ring writes compute in f32 (XLA promotes a bf16 tensor divided by a 0-d
f32 scale to f32; torch would stay in bf16) and saturate int8 codes as
XLA converts (torch's cast wraps).

Partitioned serving and training (``distributed/partition.py``): under
``Rules(partitioned=True)`` :func:`prefill` and :func:`decode_step` take
the global tokens, run the rank's batch rows on its shard of the tree
(attention on its KV heads, read from the local weights, or where the
ranks split it by column on every head, its column products gathered,
into its slots of the ring; the RG-LRU on its d_rnn features; the SSD
mixer whole; row-parallel linears reduced as int32; its experts; its
vocabulary rows) into its shard of the ring cache and states, and return
the global logits on every rank;
:func:`lm_loss` (modes "float" and "fake", every block kind) takes the
global batch and returns the global loss, with gradients through every
exchange.  :func:`forward` then takes the rank's rows.  With
``Rules.seq_tp`` (``partition.seq_split``) the residual between the
embedding and the final norm holds the rank's chunk of the sequence: each
half-block gathers its normed stream before the mixer or feed-forward and
keeps its chunk of the output (reduce-scattered after a split row-parallel
product, else narrowed).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.api import QuantConfig, dense
from repro_torch.core.quant import QTensor, pack_int4, qrange, unpack_int4
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import shard
from repro_torch.kernels.ref import gather_pages, ring_positions
from repro_torch.layers.attention import (AttnSpec, attention,
                                          paged_attention,
                                          prefix_prefill_attention)
from repro_torch.layers.embed import embed_lookup, init_embed
from repro_torch.layers.mlp import mlp
from repro_torch.layers.moe import MoEConfig, init_moe, moe_ffn
from repro_torch.layers.norms import apply_norm, init_norm
from repro_torch.layers.rglru import (init_rglru, init_rglru_state,
                                      rglru_block)
from repro_torch.layers.rope import apply_rope
from repro_torch.layers.ssd import (SSDConfig, init_ssd, init_ssd_state,
                                    ssd_block)
from repro_torch.models.scan_util import remat


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    block_pattern: tuple = ("attn",)    # cycled: attn, local, rglru, ssd
    attn_window: Optional[int] = None
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    act: str = "swiglu"
    moe: Optional[MoEConfig] = None
    ssd: Optional[SSDConfig] = None
    d_rnn: Optional[int] = None
    dtype: str = "bfloat16"
    quant: Optional[QuantConfig] = None
    q_chunk: int = 128
    loss_chunk: int = 512
    remat: bool = True
    frontend: Optional[str] = None            # "patch" (VLM stub)
    n_patches: int = 256
    causal: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)


ATTN_KINDS = ("attn", "local")


def block_kinds(cfg: LMConfig) -> list[str]:
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def unit_structure(cfg: LMConfig):
    """(unit kinds, n_units, remainder kinds)."""
    unit = tuple(cfg.block_pattern)
    n_units = cfg.n_layers // len(unit)
    rem = tuple(block_kinds(cfg)[n_units * len(unit):])
    return unit, n_units, rem


# ---------------------------------------------------------------------------
# Init (random weights from an explicit generator, on the given device)
# ---------------------------------------------------------------------------

def _lin(gen, lead, din, dout, dtype, device, bias=False):
    w = torch.randn((*lead, din, dout), generator=gen, device=device)
    p = {"w": (w * din ** -0.5).to(dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, dout), dtype=dtype, device=device)
    return p


def _init_block(gen, cfg: LMConfig, kind: str, lead, device) -> dict:
    d, hd, dt = cfg.d_model, cfg.hd, cfg.tdtype
    p = {"ln1": _stack(init_norm(d, cfg.norm, device=device), lead)}
    if kind in ATTN_KINDS:
        p["attn"] = {
            "wq": _lin(gen, lead, d, cfg.n_heads * hd, dt, device,
                       cfg.qkv_bias),
            "wk": _lin(gen, lead, d, cfg.kv_heads * hd, dt, device,
                       cfg.qkv_bias),
            "wv": _lin(gen, lead, d, cfg.kv_heads * hd, dt, device,
                       cfg.qkv_bias),
            "wo": _lin(gen, lead, cfg.n_heads * hd, d, dt, device)}
    elif kind == "rglru":
        p["rglru"] = init_rglru(gen, d, cfg.d_rnn or d, dt, lead=lead,
                                device=device)
    elif kind == "ssd":
        p["ssd"] = init_ssd(gen, d, cfg.ssd, dt, lead=lead, device=device)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0:
        ff = cfg.d_ff
        p["ln2"] = _stack(init_norm(d, cfg.norm, device=device), lead)
        if cfg.moe is not None:
            p["ffn"] = init_moe(gen, d, ff, cfg.moe, act=cfg.act, dtype=dt,
                                lead=lead, device=device)
            return p
        p["ffn"] = {"up": _lin(gen, lead, d, ff, dt, device),
                    "down": _lin(gen, lead, ff, d, dt, device)}
        if cfg.act == "swiglu":
            p["ffn"]["gate"] = _lin(gen, lead, d, ff, dt, device)
    return p


def _stack(tree: dict, lead) -> dict:
    return {k: v.expand(*lead, *v.shape).clone() for k, v in tree.items()}


def init_params(cfg: LMConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random weights (torch generator seeded with ``seed``) on ``device``,
    in the JAX package's tree layout (``units`` stacked along layers)."""
    unit, n_units, rem = unit_structure(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {"embed": init_embed(gen, cfg.vocab, cfg.d_model, cfg.tdtype,
                                  device=device),
              "final_norm": init_norm(cfg.d_model, cfg.norm, device=device),
              "lm_head": _lin(gen, (), cfg.d_model, cfg.vocab, cfg.tdtype,
                              device)}
    if n_units:
        params["units"] = {f"b{j}": _init_block(gen, cfg, kind, (n_units,),
                                                device)
                           for j, kind in enumerate(unit)}
    for i, kind in enumerate(rem):
        params[f"rem{i}"] = _init_block(gen, cfg, kind, (), device)
    return params


def _index(tree, u: int):
    """Layer ``u`` of a layer-stacked subtree, as views."""
    return {k: (_index(v, u) if isinstance(v, dict) else v[u])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Ring KV cache
# ---------------------------------------------------------------------------

def _attn_cache(cfg: LMConfig, batch: int, max_len: int, lead,
                device) -> dict:
    mode = cfg.quant.mode if cfg.quant else "float"
    if mode == "int" and cfg.quant.kv_bits == 4:
        # nibble-packed int4 ring: half the bytes read per decode step
        shape = (*lead, batch, cfg.kv_heads, max_len, cfg.hd // 2)
        dt = torch.uint8
    else:
        shape = (*lead, batch, cfg.kv_heads, max_len, cfg.hd)
        dt = torch.int8 if mode == "int" else cfg.tdtype
    c = {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
    if mode == "int":
        c["k_scale"] = torch.ones(lead, dtype=torch.float32, device=device)
        c["v_scale"] = torch.ones(lead, dtype=torch.float32, device=device)
    return c


def init_block_cache(cfg: LMConfig, kind: str, batch: int, max_len: int, *,
                     lead=(), device="cuda") -> dict:
    """One layer's ring, or its recurrent state (``lead``: stacked layer
    axes)."""
    if kind in ATTN_KINDS:
        span = max_len if (kind == "attn" or cfg.attn_window is None) \
            else min(max_len, cfg.attn_window + cfg.q_chunk)
        return _attn_cache(cfg, batch, span, lead, device)
    if kind == "rglru":
        return init_rglru_state(batch, cfg.d_rnn or cfg.d_model, lead=lead,
                                device=device)
    if kind == "ssd":
        return init_ssd_state(batch, cfg.d_model, cfg.ssd, lead=lead,
                              device=device)
    raise ValueError(kind)


def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Ring KV cache for ``batch`` sequences of up to ``max_len`` positions
    (longer runs wrap: position p lives in slot p % span)."""
    unit, n_units, rem = unit_structure(cfg)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if n_units:
        cache["units"] = {f"b{j}": init_block_cache(
            cfg, kind, batch, max_len, lead=(n_units,), device=device)
            for j, kind in enumerate(unit)}
    for i, kind in enumerate(rem):
        cache[f"rem{i}"] = init_block_cache(cfg, kind, batch, max_len,
                                            device=device)
    return cache


def _ring_codes(t, scale, kv4):
    """Codes of ``t`` on a per-tensor ``scale``, computed in f32 (``t`` may
    be bf16): int4 clipped then nibble-packed, int8 saturated (no clip in
    the reference: XLA's conversion saturates)."""
    x = torch.round(t.to(torch.float32) / scale)
    if kv4:
        qmin, qmax = qrange(4)
        return pack_int4(torch.clamp(x, qmin, qmax).to(torch.int8))
    return _sat_int8(x)


def _ring_write_prefill(cache, k, v, mode, qcfg, parts: int = 1,
                        index: int = 0, split_heads: bool = True):
    """Fill a ring from a prompt's keys/values (B, Hkv, S, hd), in place.

    Position p lands in slot p % span: a prompt longer than the ring keeps
    its last ``span`` positions, rolled into place; a shorter one is
    zero-padded.  int mode calibrates one per-tensor scale per layer on
    what the ring holds (pads included, as in the reference), over every
    rank's rows when partitioned, and over every rank's heads where the
    ranks hold some each (``split_heads``).  ``parts`` > 1: the cache
    holds slots ``[index * n, (index + 1) * n)`` of a ``parts * n``-slot
    ring (partitioned by column: every rank holds every head).
    """
    span = cache["k"].shape[2] * parts
    s_in = k.shape[2]
    if s_in >= span:
        shift = (s_in - span) % span
        ks_ = torch.roll(k[:, :, -span:], shift, dims=2)
        vs_ = torch.roll(v[:, :, -span:], shift, dims=2)
    else:
        pad = (0, 0, 0, span - s_in)
        ks_ = torch.nn.functional.pad(k, pad)
        vs_ = torch.nn.functional.pad(v, pad)
    if mode == "int":
        kv4 = qcfg.kv_bits == 4
        qmax = 7.0 if kv4 else 127.0
        grid = partition.tensor_max if split_heads else partition.rows_max
        ksc = grid(ks_.abs()).to(torch.float32) / qmax
        vsc = grid(vs_.abs()).to(torch.float32) / qmax
    if parts > 1:
        n = cache["k"].shape[2]
        ks_, vs_ = (t.narrow(2, index * n, n) for t in (ks_, vs_))
    if mode == "int":
        cache["k"].copy_(_ring_codes(ks_, ksc, kv4))
        cache["v"].copy_(_ring_codes(vs_, vsc, kv4))
        cache["k_scale"].copy_(ksc)
        cache["v_scale"].copy_(vsc)
    else:
        cache["k"].copy_(ks_)
        cache["v"].copy_(vs_)
    return cache


def _ring_write_decode(cache, k1, v1, pos, mode, parts: int = 1,
                       index: int = 0):
    """Write one decoded key/value (B, Hkv, hd) into slot ``pos % span`` on
    the ring's prefill scale, in place (``pos`` a 0-d device tensor); the
    ring's dtype says how codes are stored (uint8: int4 nibbles).
    Returns the slot -> position map of the written ring (negative =
    unwritten): ``pos - ((slot - j) mod span)``, a floor-mod.  ``parts``
    > 1 (:func:`_ring_write_prefill`): only the rank that holds the slot
    writes it (no host sync: the others write back what they hold), and
    the map is of the rank's slots."""
    n = cache["k"].shape[2]
    span = n * parts
    slot = torch.remainder(pos, span)
    if mode == "int":
        kv4 = cache["k"].dtype == torch.uint8
        kq = _ring_codes(k1, cache["k_scale"], kv4)
        vq = _ring_codes(v1, cache["v_scale"], kv4)
    else:
        kq, vq = k1, v1
    kq, vq = (t[:, :, None].to(cache["k"].dtype) for t in (kq, vq))
    local = slot - index * n
    idx = local.clamp(0, n - 1).reshape(1).long()
    if parts > 1:
        own = (local >= 0) & (local < n)
        kq = torch.where(own, kq, cache["k"].index_select(2, idx))
        vq = torch.where(own, vq, cache["v"].index_select(2, idx))
    cache["k"].index_copy_(2, idx, kq)
    cache["v"].index_copy_(2, idx, vq)
    return ring_positions(pos, span, index * n, n)


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------

def _paged_attn_cache(cfg: LMConfig, batch: int, num_pages: int,
                      page_size: int, lead, device) -> dict:
    mode = cfg.quant.mode if cfg.quant else "float"
    kv4 = mode == "int" and cfg.quant.kv_bits == 4
    dk = cfg.hd // 2 if kv4 else cfg.hd
    dt = torch.uint8 if kv4 else (torch.int8 if mode == "int"
                                  else cfg.tdtype)
    shape = (*lead, num_pages + 1, cfg.kv_heads, page_size, dk)
    c = {"k_pages": torch.zeros(shape, dtype=dt, device=device),
         "v_pages": torch.zeros(shape, dtype=dt, device=device)}
    if mode == "int":
        f32 = dict(dtype=torch.float32, device=device)
        c["k_scale"] = torch.ones((*lead, batch), **f32)
        c["v_scale"] = torch.ones((*lead, batch), **f32)
        c["page_k_scale"] = torch.ones((*lead, num_pages + 1), **f32)
        c["page_v_scale"] = torch.ones((*lead, num_pages + 1), **f32)
    return c


def init_paged_cache(cfg: LMConfig, batch: int, max_len: int, *,
                     page_size: int = 32, num_pages: Optional[int] = None,
                     device="cuda") -> dict:
    """Paged serving cache: page pools per attention layer, shared tables.

    ``max_len`` bounds one sequence (``max_pages`` = table width);
    ``num_pages`` sizes the shared pool (default ``batch * max_pages``).
    All rows start inactive (``pos = -1``) with empty page tables;
    recurrent blocks keep their ring-cache per-row states (f32, row axis
    first, after the ``units`` layer axis), so an SSD-only stack has page
    tables and ``pos`` but no pools.
    """
    unit, n_units, rem = unit_structure(cfg)
    max_pages = -(-max_len // page_size)
    if num_pages is None:
        num_pages = batch * max_pages
    i32 = dict(dtype=torch.int32, device=device)
    cache = {"pos": torch.full((batch,), -1, **i32),
             "page_table": torch.full((batch, max_pages), -1, **i32)}

    def blockc(kind, lead):
        if kind in ATTN_KINDS:
            return _paged_attn_cache(cfg, batch, num_pages, page_size, lead,
                                     device)
        return init_block_cache(cfg, kind, batch, max_len, lead=lead,
                                device=device)

    if n_units:
        cache["units"] = {f"b{j}": blockc(kind, (n_units,))
                          for j, kind in enumerate(unit)}
    for i, kind in enumerate(rem):
        cache[f"rem{i}"] = blockc(kind, ())
    return cache


def _sat_int8(x):
    """Float -> int8 saturating (NaN -> 0), as XLA converts."""
    return torch.nan_to_num(x, nan=0.0).clamp(-128, 127).to(torch.int8)


def _paged_write_decode(cache, k1, v1, positions, page_table, mode, qcfg):
    """Write one decoded key/value per sequence into its own page, in place.

    k1, v1 (B, Hkv, hd).  Row b goes to physical page
    ``page_table[b, pos_b // page_size]`` at row ``pos_b % page_size``;
    unallocated / inactive rows land in the trash page.  Codes use the
    TARGET page's registered scale (``page_k_scale[phys]``).
    """
    pos = positions[:, 0]
    num_phys = cache["k_pages"].shape[0] - 1          # last page = trash
    ps = cache["k_pages"].shape[2]
    logical = torch.div(pos, ps, rounding_mode="floor").clamp(
        0, page_table.shape[1] - 1)
    phys = torch.gather(page_table, 1, logical[:, None].long())[:, 0]
    phys = torch.where((phys >= 0) & (pos >= 0), phys, num_phys).long()
    row = torch.remainder(pos, ps).long()
    if mode == "int":
        ks = cache["page_k_scale"][phys][:, None, None]
        vs = cache["page_v_scale"][phys][:, None, None]
        if qcfg.kv_bits == 4:
            qmin, qmax = qrange(4)
            kq = pack_int4(torch.clamp(torch.round(k1 / ks), qmin, qmax)
                           .to(torch.int8))
            vq = pack_int4(torch.clamp(torch.round(v1 / vs), qmin, qmax)
                           .to(torch.int8))
        else:
            kq = _sat_int8(torch.round(k1 / ks))
            vq = _sat_int8(torch.round(v1 / vs))
    else:
        kq = k1.to(cache["k_pages"].dtype)
        vq = v1.to(cache["v_pages"].dtype)
    cache["k_pages"][phys, :, row] = kq
    cache["v_pages"][phys, :, row] = vq
    return cache


def _paged_write_prefill(cache, k, v, positions, lengths, page_table, mode,
                         qcfg, prefix_len: int = 0):
    """Scatter a (ragged) prompt's keys/values into per-row pages, in place.

    k, v (B, Hkv, S, hd) at positions ``prefix_len + i``; positions
    ``>= prefix_len + lengths[b]`` are pad: excluded from the per-sequence
    scale calibration, written to the trash page.  int mode registers the
    row's fresh scale on every fully owned allocated page (logical id
    ``>= ceil(prefix_len / page_size)``) and emits each position's codes on
    its TARGET page's registered scale.
    """
    b, _, s, _ = k.shape
    dev = k.device
    num_phys = cache["k_pages"].shape[0] - 1
    ps = cache["k_pages"].shape[2]
    lens = torch.full((b,), s, dtype=torch.int32, device=dev) \
        if lengths is None else torch.as_tensor(lengths, dtype=torch.int32,
                                                device=dev)
    valid = positions < (prefix_len + lens)[:, None]          # (B, S)
    logical = torch.div(positions, ps, rounding_mode="floor").clamp(
        0, page_table.shape[1] - 1)
    phys = torch.gather(page_table, 1, logical.long())        # (B, S)
    phys = torch.where(valid & (phys >= 0), phys, num_phys).long()
    row = torch.remainder(positions, ps).long()
    if mode == "int":
        kv4 = qcfg.kv_bits == 4
        qmin, qmax = qrange(4) if kv4 else qrange(8)
        vmask = valid[:, None, :, None]

        def rowscale(t):
            amax = (t.abs() * vmask).amax(dim=(1, 2, 3))
            return torch.clamp(amax.to(torch.float32), min=1e-8) / qmax

        ksc, vsc = rowscale(k), rowscale(v)
        cache["k_scale"].copy_(ksc)
        cache["v_scale"].copy_(vsc)
        own_from = -(-prefix_len // ps)
        maxp = page_table.shape[1]
        ownable = (torch.arange(maxp, device=dev)[None, :] >= own_from) & \
            (page_table >= 0)
        tgt = torch.where(ownable, page_table, num_phys).long()
        pks, pvs = cache["page_k_scale"], cache["page_v_scale"]
        pks[tgt] = ksc[:, None].expand(b, maxp)
        pvs[tgt] = vsc[:, None].expand(b, maxp)
        kstep = pks[phys][:, None, :, None]                   # (B,1,S,1)
        vstep = pvs[phys][:, None, :, None]
        kq = torch.clamp(torch.round(k / kstep), qmin, qmax).to(torch.int8)
        vq = torch.clamp(torch.round(v / vstep), qmin, qmax).to(torch.int8)
        if kv4:
            kq, vq = pack_int4(kq), pack_int4(vq)
    else:
        kq = k.to(cache["k_pages"].dtype)
        vq = v.to(cache["v_pages"].dtype)
    cache["k_pages"][phys, :, row] = kq.transpose(1, 2)        # (B,S,Hkv,dk)
    cache["v_pages"][phys, :, row] = vq.transpose(1, 2)
    return cache


def _ring_split_decode(q, k, v, spec, qcfg, pos, k_positions, part):
    """A decode step over a ring split by slot range over the model ranks
    (``k``, ``v``, ``k_positions``: this rank's slots; ``q`` every head).
    Where the kernel runs by stages, the exchanges between them are the
    partitioned program's (``dispatch.maybe_staged_decode``); elsewhere
    the ranks all-gather the ring's codes (bytes) and attend the whole
    ring as one rank does.  Either way the result is one rank's, bit for
    bit."""
    from repro_torch.kernels.dispatch import maybe_staged_decode
    out = maybe_staged_decode(
        q, k, v, spec, qcfg, pos, k_positions, parts=part.m, index=part.j,
        gather=lambda t: part.gather(t, ("model",), dim=1), reduce=part.sum)
    if out is not None:
        return out
    whole = [part.gather(t.q if isinstance(t, QTensor) else t, ("model",),
                         dim=2) for t in (k, v)]
    k, v = (QTensor(w, t.scale, t.bits) if isinstance(t, QTensor) else w
            for w, t in zip(whole, (k, v)))
    return attention(q, k, v, spec, qcfg, q_offset=pos,
                     k_positions=ring_positions(pos, k.shape[2]))


def _attn_mixer(x, p, cfg: LMConfig, kind: str, positions, cache, decode,
                page_table=None, lengths=None, prefix_len: int = 0,
                seq: bool = False):
    # Partitioned by column (partition.split_plan): each rank's column
    # products are all-gathered (bytes: exact), so every model rank holds
    # every head, attends them all, keeps its slots of the ring, and feeds
    # its K slice of the output to wo.  Else the heads this rank holds (all
    # of them unless partitioned).
    hd = cfg.hd
    cols = partition.attn_columns(cfg)
    q_cols = partition.out_features(p["wq"])
    qcfg = cfg.quant
    x = partition.model_input(x, q_cols < cfg.n_heads * hd, seq)
    b, s, _ = x.shape
    part = partition.active()

    def proj(w):
        y = shard(dense(x, w, qcfg), "batch", None, "model")
        if cols:
            y = part.gather(y, ("model",), dim=-1)
        return y.reshape(b, s, -1, hd).transpose(1, 2)

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    hq = q.shape[1]
    # the rank's slot range of the ring, unless it holds the whole ring
    ring = {"parts": part.m, "index": part.j} if cols and cache is not None \
        and partition.RING_WHOLE not in cache else {}
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   rotary_frac=cfg.rotary_frac)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   rotary_frac=cfg.rotary_frac)

    window = cfg.attn_window if kind == "local" else None
    spec = AttnSpec(causal=cfg.causal, window=window, q_chunk=cfg.q_chunk,
                    split_heads=hq < cfg.n_heads)
    mode = qcfg.mode if qcfg else "float"
    paged = cache is not None and "k_pages" in cache

    if paged and decode:
        _paged_write_decode(cache, k[:, :, 0], v[:, :, 0], positions,
                            page_table, mode, qcfg)
        ones = torch.ones((b,), dtype=torch.float32, device=x.device)
        out = paged_attention(q, cache["k_pages"], cache["v_pages"],
                              cache.get("k_scale", ones),
                              cache.get("v_scale", ones),
                              page_table, positions[:, 0], spec, qcfg,
                              k_page_scale=cache.get("page_k_scale"),
                              v_page_scale=cache.get("page_v_scale"))
    elif paged and prefix_len:
        # Tail chunk over an already-cached prefix: the tail attends the
        # prefix through its stored codes on the pages' own grids.
        ps_ = cache["k_pages"].shape[2]
        npre = -(-prefix_len // ps_)
        num_phys = cache["k_pages"].shape[0] - 1
        k_pre = gather_pages(cache["k_pages"], page_table[:, :npre])
        v_pre = gather_pages(cache["v_pages"], page_table[:, :npre])
        if mode == "int":
            if k_pre.dtype == torch.uint8:
                k_pre, v_pre = unpack_int4(k_pre), unpack_int4(v_pre)
            idx = page_table[:, :npre].long().clamp(0, num_phys)
            pks = cache["page_k_scale"][idx]
            pvs = cache["page_v_scale"][idx]
        else:
            pks = pvs = None
        out = prefix_prefill_attention(q, k, v, k_pre, v_pre, pks, pvs,
                                       prefix_len, lengths, spec, qcfg)
        _paged_write_prefill(cache, k, v, positions, lengths, page_table,
                             mode, qcfg, prefix_len=prefix_len)
    elif paged:
        out = attention(q, k, v, spec, qcfg, q_offset=0)
        _paged_write_prefill(cache, k, v, positions, lengths, page_table,
                             mode, qcfg)
    elif cache is not None and decode:
        # Ring decode: write slot pos % span, then attend the ring as
        # stored (int4 nibbles stay packed for the kernel).
        pos = positions[0, 0]
        k_positions = _ring_write_decode(cache, k[:, :, 0], v[:, :, 0], pos,
                                         mode, **ring)
        if mode == "int":
            k_all = QTensor(cache["k"], cache["k_scale"], qcfg.kv_bits)
            v_all = QTensor(cache["v"], cache["v_scale"], qcfg.kv_bits)
        else:
            k_all, v_all = cache["k"], cache["v"]
        if ring:
            out = _ring_split_decode(q, k_all, v_all, spec, qcfg, pos,
                                     k_positions, part)
        else:
            out = attention(q, k_all, v_all, spec, qcfg, q_offset=pos,
                            k_positions=k_positions)
    else:
        # Prompt positions are arange(S): a static zero offset, so prompt
        # prefill can take the fused kernel.
        out = attention(q, k, v, spec, qcfg,
                        q_offset=positions[0, 0] if decode else 0)
        if cache is not None:
            _ring_write_prefill(cache, k, v, mode, qcfg, **ring,
                                split_heads=spec.split_heads)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    if cols:                      # this rank's K slice of wo
        out = part.take(out, ("model",), dim=-1)
    return dense(out, p["wo"], qcfg, tp="row",
                 k_split=q_cols < cfg.n_heads * hd, seq=seq)


def _norm(x, p, cfg: LMConfig, seq: bool):
    """``apply_norm`` on the residual.  Under the sequence split (``seq``)
    each rank normalizes its own rows, so the gains' gradients sum over
    "model" (``Partition.shared``)."""
    if seq:
        part = partition.active()
        p = {k: part.shared(v) for k, v in p.items()}
    return apply_norm(x, p, cfg.norm)


def mixer_block(x, p, cfg: LMConfig, kind: str, *, positions, cache=None,
                decode=False, page_table=None, lengths=None,
                prefix_len: int = 0, seq: bool = False):
    """The first half of a block: x + mixer(norm(x)), the mixer attention,
    RG-LRU or SSD.  A recurrent block starts from no state at prefill and
    from the cache's at decode; its new state is written into the cache in
    place.  ``seq`` (``partition.seq_split``): x holds this rank's chunk
    of the sequence; the normed stream is gathered before the mixer, which
    runs on the whole sequence, and its output comes back as the rank's
    chunk (reduce-scattered after a split row-parallel product, else
    narrowed)."""
    h = shard(_norm(x, p["ln1"], cfg, seq), "batch", "seq_tp", None)
    if kind in ATTN_KINDS:
        out = _attn_mixer(h, p["attn"], cfg, kind, positions, cache, decode,
                          page_table, lengths, prefix_len, seq)
        return x + out.to(x.dtype)
    state = cache if decode else None
    if kind == "rglru":
        split = partition.out_features(p["rglru"]["w_in"]) < \
            partition.d_rnn(cfg)
        out, new = rglru_block(h, p["rglru"], cfg.quant, state=state,
                               k_split=split, seq=seq)
    elif kind == "ssd":
        out, new = ssd_block(partition.model_input(h, False, seq), p["ssd"],
                             cfg.ssd, cfg.quant, state=state)
        out = partition.seq_rows(out, seq)
    else:
        raise ValueError(kind)
    if cache is not None:
        for key, leaf in new.items():
            cache[key].copy_(leaf)
    return x + out.to(x.dtype)


def ffn(h2, p, cfg: LMConfig, seq: bool = False):
    """The feed-forward on the normed stream (B, S, d): the MLP, or the MoE
    FFN on the flattened (B*S, d) tokens.  Returns (out, aux): ``aux`` holds
    MoE's ``lb_loss`` (empty for the MLP).  ``seq``: h2 and out hold this
    rank's chunk of the sequence (:func:`mixer_block`); the MoE FFN runs
    on every token of the gathered stream, its capacity unchanged."""
    if cfg.moe is None:
        split = partition.out_features(p["ffn"]["up"]) < cfg.d_ff
        return mlp(h2, p["ffn"], cfg.quant, act=cfg.act, k_split=split,
                   seq=seq), {}
    h2 = partition.model_input(h2, False, seq)
    b, s, d = h2.shape
    out, aux = moe_ffn(h2.reshape(b * s, d), p["ffn"], cfg.moe, cfg.quant,
                       act=cfg.act)
    return partition.seq_rows(out.reshape(b, s, d), seq), aux


def ffn_block(x, p, cfg: LMConfig, seq: bool = False):
    """The second half of a block: x + ffn(norm(x)) (x itself when the
    config has no feed-forward).  Returns (x, aux) as :func:`ffn`."""
    if cfg.d_ff <= 0:
        return x, {}
    out, aux = ffn(_norm(x, p["ln2"], cfg, seq), p, cfg, seq)
    return x + out.to(x.dtype), aux


def apply_block(x, p, cfg: LMConfig, kind: str, **kw):
    """One block; returns (x, aux) as :func:`ffn_block`."""
    x, aux = ffn_block(mixer_block(x, p, cfg, kind, **kw), p, cfg,
                       kw.get("seq", False))
    return shard(x, "batch", "seq_tp", None), aux


def _blocks(x, aux, ps, kinds, caches, cfg, kw):
    """Blocks ``kinds`` in turn, their ``lb_loss`` added to ``aux`` in
    the reference's order."""
    for p, kind, c in zip(ps, kinds, caches):
        x, a = apply_block(x, p, cfg, kind, cache=c, **kw)
        if "lb_loss" in a:
            aux = aux + a["lb_loss"]
    return x, aux


def stack_forward(x, params, cfg: LMConfig, *, positions, cache=None,
                  decode=False, page_table=None, lengths=None,
                  prefix_len: int = 0, seq: bool = False):
    """The blocks over x; returns (x, aux), ``aux`` the f32 sum of the MoE
    load-balance losses (0 without MoE).  With ``cfg.remat``, grad enabled
    and no cache, each pattern unit is recomputed in the backward pass.
    ``seq``: x holds this rank's chunk of the sequence
    (``partition.seq_split``), and so does the result."""
    unit, n_units, rem = unit_structure(cfg)
    kw = dict(positions=positions, decode=decode, page_table=page_table,
              lengths=lengths, prefix_len=prefix_len, seq=seq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    unit_blocks = remat(_blocks, cfg.remat and cache is None)
    for u in range(n_units):
        up = _index(params["units"], u)
        uc = _index(cache["units"], u) if cache is not None else None
        ps = [up[f"b{j}"] for j in range(len(unit))]
        cs = [None if uc is None else uc[f"b{j}"] for j in range(len(unit))]
        x, aux = unit_blocks(x, aux, ps, unit, cs, cfg, kw)
    ps = [params[f"rem{i}"] for i in range(len(rem))]
    cs = [None if cache is None else cache[f"rem{i}"]
          for i in range(len(rem))]
    return _blocks(x, aux, ps, rem, cs, cfg, kw)


def _inputs_to_x(params, batch, cfg: LMConfig):
    x = embed_lookup(batch["tokens"], params["embed"], cfg.tdtype,
                     vocab=cfg.vocab)
    if cfg.frontend == "patch" and "patches" in batch:
        x = torch.cat([batch["patches"].to(cfg.tdtype), x], dim=1)
    return shard(x, "batch", None, None)


def forward(params, batch, cfg: LMConfig, *, cache=None, decode=False,
            prefix_len: int = 0):
    """Returns (pre-head hidden states, cache, aux); ``aux`` is the f32
    sum of the MoE load-balance losses (0 without MoE), as the reference's.

    With a ring cache, ``cache["pos"]`` is one 0-d position for the whole
    batch (prompt positions start at 0; ``pos`` advances by S at prefill
    and by 1 per decode step; at prefill S counts the patch embeddings of a
    ``"patch"`` frontend).  With a paged cache, ``cache["pos"]`` is
    per sequence (B,): each row decodes at its own position and inactive
    rows (``pos < 0``) stay frozen; ragged prefill takes
    ``batch["lengths"]`` and leaves ``pos = prefix_len + lengths``.
    ``prefix_len``: ``batch["tokens"]`` is the tail of a prompt whose
    first ``prefix_len`` positions are already cached (prefix sharing /
    chunked prefill).  Cache writes
    happen in place (module docstring).  Under partitioned rules ``batch``
    holds the rank's rows and ``params`` / ``cache`` its shards
    (:func:`repro_torch.distributed.partition.check_tree`).
    """
    paged = cache is not None and "page_table" in cache
    if paged:
        partition.refuse("the paged cache (launch/engine.py)",
                         partition.PAGED)
    partition.check_tree(params, cfg)
    x = _inputs_to_x(params, batch, cfg)
    page_table = cache["page_table"] if paged else None
    lengths = batch.get("lengths") if paged and not decode else None
    b, s = x.shape[0], x.shape[1]
    if decode:
        positions = cache["pos"][:, None] if paged else \
            cache["pos"].expand(b, 1)
    else:
        positions = (prefix_len + torch.arange(s, device=x.device,
                                               dtype=torch.int32)
                     )[None, :].expand(b, s)
    # the residual's sequence over "model" (Rules.seq_tp) from here to the
    # final norm; whole for a call whose S the model ranks do not divide
    seq = partition.seq_split(s)
    x = partition.seq_rows(x, seq)
    x, aux = stack_forward(x, params, cfg, positions=positions, cache=cache,
                           decode=decode, page_table=page_table,
                           lengths=lengths,
                           prefix_len=0 if decode else prefix_len, seq=seq)
    x = _norm(x, params["final_norm"], cfg, seq)
    if seq:
        x = partition.active().gather(x, ("model",), dim=1)
    if paged:
        pos = cache["pos"]
        if decode:           # inactive rows (pos < 0) do not advance
            pos.copy_(torch.where(pos >= 0, pos + 1, pos))
        elif lengths is None:
            pos.fill_(prefix_len + s)
        else:
            pos.copy_(prefix_len + torch.as_tensor(lengths, dtype=torch.int32,
                                                   device=pos.device))
    elif cache is not None:                    # ring: one shared position
        cache["pos"].add_(1 if decode else s)
    return x, cache, aux


def logits_fn(params, x, cfg: LMConfig):
    """Logits over the whole vocabulary (gathered over "model" where the
    rank holds a block of the lm_head's rows; the gather hands each rank
    its block's gradient)."""
    split = partition.out_features(params["lm_head"]) != cfg.vocab
    y = dense(partition.model_input(x, split), params["lm_head"], cfg.quant)
    if split:
        y = partition.active().gather(y, ("model",), dim=-1)
    return y


def chunked_nll(x, labels, loss_chunk: int, head):
    """Mean next-token NLL of ``labels`` (B, S) from hidden states x (B, S,
    d), ``head`` turning a chunk of x into logits, so (B, S, V) logits never
    exist at once.  The chunk is the largest one <= ``loss_chunk`` that
    divides S; the f32 ``logsumexp - gold`` sums chunk by chunk in the
    reference's order.  Under partitioned rules x and ``labels`` hold the
    rank's rows: the sum runs over every batch rank's (its backward the
    identity) and the mean is over the global B * S."""
    b, s, _ = x.shape
    c = next(cc for cc in range(min(loss_chunk, s), 0, -1) if s % cc == 0)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        logits = head(x[:, i:i + c]).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, i:i + c, None].long())[..., 0]
        tot = tot + torch.sum(logz - gold)
    part = partition.active()
    if part is not None:
        tot, b = part.sum(tot, part.batch), b * part.n_dp
    return tot / (b * s)


def lm_loss(params, batch, cfg: LMConfig):
    """Causal LM loss on ``batch["tokens"]`` and ``batch["labels"]`` (B, S)
    (plus ``patches`` for a patch frontend, whose positions take no loss),
    :func:`chunked_nll` over ``cfg.loss_chunk``.  Returns (nll + 0.01 *
    aux, {"nll", "aux"}).

    Partitioned (modes "float" and "fake"): the global batch in, the rank's
    rows run on its shard of the tree, and every rank returns the global
    loss.  A rank's backward gives its part of each gradient, from its own
    rows (``aux``, the same on every batch rank, counted once), which the
    train step sums over the batch axes (``launch/train.py``)."""
    part = partition.active()
    if part is not None:
        if cfg.quant is not None and cfg.quant.mode == "int":
            partition.refuse("training in int mode (lm_loss; item 6c.1 "
                             "trains modes 'float' and 'fake')",
                             partition.ROADMAP_ITEM)
        batch = {k: part.batch_rows(v) for k, v in batch.items()}
    x, _, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    if cfg.frontend == "patch":                   # frontend tokens: no loss
        x = x[:, -labels.shape[1]:]
    loss = chunked_nll(x, labels, cfg.loss_chunk,
                       lambda xc: logits_fn(params, xc, cfg))
    counted = aux if part is None else part.counted(aux)
    return loss + 0.01 * counted, {"nll": loss, "aux": aux}


def prefill(params, batch, cfg: LMConfig, max_len: Optional[int] = None):
    """Run the whole prompt into a new ring cache (on the tokens' device).

    ``batch["tokens"]`` (B, S), and ``batch["patches"]`` (B, n_patches, d)
    for a ``"patch"`` frontend (prepended, so the prompt is n_patches + S
    positions); the ring holds ``max_len`` positions (default S, as in the
    reference: a prompt with patches then wraps).  Returns (last-position
    logits (B, 1, V), cache).  Partitioned: the global batch in, the
    global logits out on every rank, and the rank's shard of the cache
    (:func:`repro_torch.distributed.partition.init_cache`)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    part = partition.active()
    if part is None:
        cache = init_cache(cfg, b, max_len or s, device=tokens.device)
    else:
        cache = partition.init_cache(cfg, b, max_len or s, part.layout,
                                     device=tokens.device)
        batch = {k: part.batch_rows(v) for k, v in batch.items()}
    x, cache, _ = forward(params, batch, cfg, cache=cache, decode=False)
    return _global_logits(params, x[:, -1:], cfg, part), cache


def _global_logits(params, x, cfg, part):
    logits = logits_fn(params, x, cfg)
    return logits if part is None else part.gather(logits, part.batch)


def paged_prefill(params, batch, cfg: LMConfig, cache, *,
                  prefix_len: int = 0):
    """Ragged prompt prefill into an existing paged cache (in place).

    ``batch["tokens"]`` (B, S) right-padded, ``batch["lengths"]`` (B,).
    Pages named by ``cache["page_table"]`` must be allocated for every
    row's prompt; pad positions write to the trash page.  Returns
    (last-real-position logits (B, 1, V), cache).  A recurrent block
    scans the whole padded row from a zero state (``prefix_len`` or not),
    as the reference's does: its state takes in the pads.
    """
    x, cache, _ = forward(params, batch, cfg, cache=cache, decode=False,
                       prefix_len=prefix_len)
    lengths = batch.get("lengths")
    if lengths is None:
        last = x[:, -1:]
    else:
        idx = (torch.as_tensor(lengths, device=x.device).long() - 1).clamp(
            0, x.shape[1] - 1)
        last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    return logits_fn(params, last, cfg), cache


# Cache leaves indexed by PHYSICAL page id (shared across sequences).
POOL_KEYS = ("k_pages", "v_pages", "page_k_scale", "page_v_scale")


def copy_page(cache, src: int, dst: int):
    """Duplicate physical page ``src`` into ``dst`` across every pool leaf
    (codes and per-page scales, every attention layer), in place: the
    device half of the engine's copy-on-write."""
    def walk(c, stacked):
        for key, leaf in c.items():
            if isinstance(leaf, dict):
                walk(leaf, stacked or key == "units")
            elif key in POOL_KEYS:
                if stacked:
                    leaf[:, dst] = leaf[:, src]
                else:
                    leaf[dst] = leaf[src]

    walk(cache, False)
    return cache


def page_scale_pools(cache):
    """Yield ``(path, page_k_scale, page_v_scale)`` for every attention
    layer's per-physical-page scale pools (``units`` leaves carry a leading
    layer axis; the trash page is included)."""
    def walk(c, path):
        if "page_k_scale" in c:
            yield path, c["page_k_scale"], c["page_v_scale"]
        for key, leaf in c.items():
            if isinstance(leaf, dict):
                yield from walk(leaf, f"{path}/{key}" if path else key)

    yield from walk(cache, "")


def _admission_view(cache, w: int, page_table):
    """W-row prefill view over a B-row paged cache: pool leaves are the
    serving cache's own tensors (writes land there), per-row leaves are
    fresh zeros (prefill overwrites them before anything reads them)."""
    def walk(c, stacked):
        out = {}
        for key, leaf in c.items():
            if isinstance(leaf, dict):
                out[key] = walk(leaf, stacked or key == "units")
            elif key in POOL_KEYS:
                out[key] = leaf
            elif stacked:
                out[key] = torch.zeros((leaf.shape[0], w) + leaf.shape[2:],
                                       dtype=leaf.dtype, device=leaf.device)
            else:
                out[key] = torch.zeros((w,) + leaf.shape[1:],
                                       dtype=leaf.dtype, device=leaf.device)
        return out

    view = walk({k: v for k, v in cache.items()
                 if k not in ("pos", "page_table")}, False)
    dev = cache["pos"].device
    view["pos"] = torch.zeros((w,), dtype=torch.int32, device=dev)
    view["page_table"] = torch.as_tensor(page_table, dtype=torch.int32,
                                         device=dev)
    return view


def _install_rows(cache, view, rows):
    """Scatter a W-row admission view's per-row leaves into the B-row cache
    at ``rows`` (pools are shared already; ``pos``/``page_table`` stay the
    host-owned values of the big cache)."""
    def walk(big, small, stacked):
        for key, bleaf in big.items():
            if isinstance(bleaf, dict):
                walk(bleaf, small[key], stacked or key == "units")
            elif key in POOL_KEYS:
                continue
            elif stacked:
                bleaf[:, rows] = small[key]
            else:
                bleaf[rows] = small[key]

    walk({k: v for k, v in cache.items() if k not in ("pos", "page_table")},
         view, False)
    return cache


def admission_prefill(params, batch, cfg: LMConfig, cache, rows, page_table,
                      *, prefix_len: int = 0):
    """Batched ragged admission prefill straight into the shared pools.

    ``batch["tokens"]`` (W, S) right-padded to one bucket with
    ``batch["lengths"]`` (W,); ``page_table`` (W, max_pages) holds each
    admission's reserved physical pages; ``rows`` (W,) names the decode
    rows they occupy.  Codes land at the reserved pages, per-row leaves at
    ``rows``; per-sequence activation grids make each row bit-identical to
    a solo prefill.  ``prefix_len``: the tokens are prompt tails whose first
    ``prefix_len`` positions are already cached (prefix sharing, resumable
    chunks).  Returns (last-real-position logits (W, 1, V), cache).
    Recurrent states start from zeros at every call, chunks after the
    first included, as in the reference (ROADMAP queue 3).
    """
    w = batch["tokens"].shape[0]
    view = _admission_view(cache, w, page_table)
    logits, view = paged_prefill(params, batch, cfg, view,
                                 prefix_len=prefix_len)
    rows = torch.as_tensor(rows, dtype=torch.long, device=cache["pos"].device)
    return logits, _install_rows(cache, view, rows)


def decode_step(params, token, cache, cfg: LMConfig):
    """One serving step: token (B, 1) + ring or paged cache -> logits
    (B, 1, V); the cache is updated in place.  Partitioned: the global
    tokens in, the global logits out, the rank's shard of the ring."""
    part = partition.active()
    if part is not None:
        token = part.batch_rows(token)
    x, cache, _ = forward(params, {"tokens": token}, cfg, cache=cache,
                       decode=True)
    return _global_logits(params, x, cfg, part), cache
