"""Whisper-style encoder-decoder backbone (conv frontend stubbed), in
PyTorch.  Counterpart of ``repro/models/encdec.py``:
:class:`EncDecConfig`, :func:`init_params`, :func:`encode`,
:func:`init_cache`, :func:`decoder_embed`, :func:`prefill`,
:func:`decode_step` and the training loss :func:`loss_fn` (teacher-forced,
chunked over the target length; with ``cfg.remat`` and grad enabled each
encoder layer, and each decoder layer run without a cache, is recomputed
in the backward pass).

The audio frontend is a stub: the caller gives frame embeddings (B,
n_audio_ctx, d_model).  Self- and cross-attention run the port's attention
core; the cross K/V are computed once at prefill and kept as int8 codes.
Layers are stacked along a leading axis (``enc_layers``, ``dec_layers``)
and run as a loop over it, as the reference scans them.

Cache (the reference's layout): ``layers`` holds per decoder layer the
self-attention ring ``k``/``v`` (L, B, H, max_len, hd), the cross K/V
``ek``/``ev`` (L, B, H, n_audio_ctx, hd), 0-d scales per layer (``(L,)``
stacked) and a per-layer ``pos`` (L,); the top-level ``pos`` is 0-d.  Int
mode stores int8 codes on one per-tensor scale.  :func:`prefill` fills
the cache it creates and :func:`decode_step` writes the new key / value
into slot ``pos % max_len`` and advances both ``pos`` in place; ``pos``
stays on the device.  A prompt at least ``max_len`` long keeps its last
``max_len`` positions unrolled (reference ``_fill_cache``), so the first
decode step overwrites slot 0, as the reference does.  Int8 casts saturate
as XLA's do (torch's would wrap).

Partitioned serving (``distributed/partition.py``, mode "int"): under
``Rules(partitioned=True)`` :func:`prefill` and :func:`decode_step` take
the global frames and tokens, run the rank's batch rows on its shard of
the tree (attention on its heads, wq, wk, wv and their biases by
columns, wo by K; the MLP's up by columns, down by K; its vocabulary
rows) into its shard of the cache (rings and cross K/V by row and head),
and return the global logits on every rank.  Every row-parallel product
reduces its int32 sums over "model" and adds its bias once, after the
reduce; per-tensor cache scales max over every rank's heads and rows.
Partitioned training (modes "float" and "fake"): :func:`loss_fn` under the
same rules, its gradients through every exchange (an attention's inputs,
the encoder states into each cross-attention's K/V included, sum theirs
over "model").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.api import QuantConfig, dense
from repro_torch.core.quant import QTensor
from repro_torch.distributed import partition
from repro_torch.layers.attention import AttnSpec, attention
from repro_torch.layers.embed import embed_lookup, init_embed
from repro_torch.layers.mlp import mlp
from repro_torch.layers.norms import apply_norm, init_norm
from repro_torch.models.lm import (_global_logits, _lin,
                                    _ring_write_decode, _sat_int8, _stack,
                                    chunked_nll, logits_fn)
from repro_torch.models.scan_util import _index, remat

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_audio_ctx: int = 1500
    dtype: str = "bfloat16"
    quant: Optional[QuantConfig] = None
    q_chunk: int = 128
    loss_chunk: int = 512
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "EncDecConfig":
        return dataclasses.replace(self, **kw)


def _mode(cfg: EncDecConfig) -> str:
    return cfg.quant.mode if cfg.quant else "float"


def _inv_freq(d: int, device) -> torch.Tensor:
    """``10000 ** (2 * dim / d)`` for dim < d / 2, in f32 as JAX forms it."""
    dim = torch.arange(d // 2, device=device, dtype=_F32)
    return torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)


def _sinusoid_rows(pos, d: int) -> torch.Tensor:
    """Rows ``pos`` (any int tensor) of the reference's ``_sinusoid``
    table: [sin(p / f), cos(p / f)] -> (..., d) f32."""
    ang = pos.to(_F32)[..., None] / _inv_freq(d, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid(n: int, d: int, device) -> torch.Tensor:
    return _sinusoid_rows(torch.arange(n, device=device), d)


# ---------------------------------------------------------------------------
# Init (random weights from an explicit generator, layer-stacked)
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: EncDecConfig, lead, device) -> dict:
    # Whisper: q, v and o projections biased, k unbiased.
    d, dt = cfg.d_model, cfg.tdtype
    hh = cfg.n_heads * cfg.hd
    return {"wq": _lin(gen, lead, d, hh, dt, device, True),
            "wk": _lin(gen, lead, d, hh, dt, device, False),
            "wv": _lin(gen, lead, d, hh, dt, device, True),
            "wo": _lin(gen, lead, hh, d, dt, device, True)}


def _init_mlp(gen, cfg: EncDecConfig, lead, device) -> dict:
    d, ff, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
    return {"up": _lin(gen, lead, d, ff, dt, device, True),
            "down": _lin(gen, lead, ff, d, dt, device, True)}


def _ln(cfg, lead, device):
    return _stack(init_norm(cfg.d_model, "layernorm", device=device), lead)


def init_layer(gen, cfg: EncDecConfig, kind: str, lead=(),
               device="cuda") -> dict:
    """An encoder ("enc") or decoder ("dec") layer's random weights
    (``lead``: stacked layer axes)."""
    if kind == "enc":
        return {"ln1": _ln(cfg, lead, device),
                "attn": _init_attn(gen, cfg, lead, device),
                "ln2": _ln(cfg, lead, device),
                "mlp": _init_mlp(gen, cfg, lead, device)}
    return {"ln1": _ln(cfg, lead, device),
            "self_attn": _init_attn(gen, cfg, lead, device),
            "ln2": _ln(cfg, lead, device),
            "cross_attn": _init_attn(gen, cfg, lead, device),
            "ln3": _ln(cfg, lead, device),
            "mlp": _init_mlp(gen, cfg, lead, device)}


def init_params(cfg: EncDecConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random weights (torch generator seeded with ``seed``) on ``device``,
    in the JAX package's tree layout."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "embed": init_embed(gen, cfg.vocab, cfg.d_model, cfg.tdtype,
                            device=device),
        "enc_layers": init_layer(gen, cfg, "enc", (cfg.n_enc_layers,),
                                 device),
        "dec_layers": init_layer(gen, cfg, "dec", (cfg.n_dec_layers,),
                                 device),
        "enc_ln": init_norm(cfg.d_model, "layernorm", device=device),
        "dec_ln": init_norm(cfg.d_model, "layernorm", device=device),
        "lm_head": _lin(gen, (), cfg.d_model, cfg.vocab, cfg.tdtype, device),
    }


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _proj(x, p, cfg: EncDecConfig):
    """(B, S, d) -> (B, H, S, hd) over the heads ``p`` holds."""
    b, s, _ = x.shape
    y = dense(x, p, cfg.quant)
    return y.reshape(b, s, -1, cfg.hd).transpose(1, 2)


def _split(p, cfg: EncDecConfig) -> bool:
    """Whether the rank holds some of the heads of attention ``p``."""
    return partition.out_features(p["wq"]) < cfg.n_heads * cfg.hd


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _attn(x, kv_x, p, cfg: EncDecConfig, *, causal, kv_override=None):
    """Attention of ``x`` over ``kv_x`` (``x`` itself when None), or over
    ``kv_override``'s stored K/V; returns (out, (k, v)).  Partitioned,
    ``x`` and ``kv_x`` enter the rank's heads: their gradients sum over
    "model"."""
    split = _split(p, cfg)
    xs = partition.model_input(x, split)
    q = _proj(xs, p["wq"], cfg)
    if kv_override is not None:
        k, v = kv_override
    else:
        kv_x = xs if kv_x is None or kv_x is x else \
            partition.model_input(kv_x, split)
        k = _proj(kv_x, p["wk"], cfg)
        v = _proj(kv_x, p["wv"], cfg)
    spec = AttnSpec(causal=causal, q_chunk=cfg.q_chunk, split_heads=split)
    out = attention(q, k, v, spec, cfg.quant)
    return dense(_merge(out), p["wo"], cfg.quant, tp="row",
                 k_split=split), (k, v)


def _mlp(x, p, cfg: EncDecConfig):
    split = partition.out_features(p["up"]) < cfg.d_ff
    return mlp(x, p, cfg.quant, act="gelu", k_split=split)


def _enc_layer(x, p, cfg: EncDecConfig):
    h, _ = _attn(apply_norm(x, p["ln1"], "layernorm"), None, p["attn"],
                 cfg, causal=False)
    x = x + h.to(x.dtype)
    return x + _mlp(apply_norm(x, p["ln2"], "layernorm"), p["mlp"],
                    cfg).to(x.dtype)


def encode(params, frames, cfg: EncDecConfig):
    """frames (B, n_audio_ctx, d_model) stub embeddings -> encoder states.
    Partitioned: the rank's rows of ``frames``, on its heads."""
    x = frames.to(cfg.tdtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(cfg.tdtype)
    layer = remat(_enc_layer, cfg.remat)
    for i in range(cfg.n_enc_layers):
        x = layer(x, _index(params["enc_layers"], i), cfg)
    return apply_norm(x, params["enc_ln"], "layernorm")


def _quant_pair(k, v):
    """int8 codes of k and v, each on one per-tensor scale (over every
    rank's heads and rows when partitioned; f32 division, saturating
    cast)."""
    def one(t):
        s = torch.clamp(partition.tensor_max(t.abs()), min=1e-8).to(_F32) \
            / 127.
        return _sat_int8(torch.round(t.to(_F32) / s)), s

    (kq, ks), (vq, vs) = one(k), one(v)
    return kq, vq, ks, vs


def _fill_cache(c, sk, sv, ek, ev, cfg: EncDecConfig):
    """Write the prompt's self-attention K/V (the first ``span`` positions
    zero-padded, or the last ``span``) and the cross K/V into one layer's
    cache, in place."""
    span = c["k"].shape[2]
    s_in = sk.shape[2]
    if s_in < span:
        pad = (0, 0, 0, span - s_in)
        sk = torch.nn.functional.pad(sk, pad)
        sv = torch.nn.functional.pad(sv, pad)
    else:
        sk, sv = sk[:, :, -span:], sv[:, :, -span:]
    if _mode(cfg) == "int":
        for (kk, vk, ksk, vsk), (a, b) in (
                (("k", "v", "k_scale", "v_scale"), (sk, sv)),
                (("ek", "ev", "ek_scale", "ev_scale"), (ek, ev))):
            aq, bq, asc, bsc = _quant_pair(a, b)
            c[kk].copy_(aq)
            c[vk].copy_(bq)
            c[ksk].copy_(asc)
            c[vsk].copy_(bsc)
    else:
        for key, t in (("k", sk), ("v", sv), ("ek", ek), ("ev", ev)):
            c[key].copy_(t)


def _self_attn_decode(h_in, p, c, cfg: EncDecConfig):
    """One decode step of the self-attention over the layer's ring: the new
    key / value into slot ``pos % span`` (in place; int8 codes on the
    prefill scale, saturating), then attention over the ring as stored."""
    qpos = c["pos"]
    k1 = _proj(h_in, p["wk"], cfg)[:, :, 0]
    v1 = _proj(h_in, p["wv"], cfg)[:, :, 0]
    kpos = _ring_write_decode(c, k1, v1, qpos, _mode(cfg))
    if _mode(cfg) == "int":
        bits = cfg.quant.kv_bits
        k_all = QTensor(c["k"], c["k_scale"], bits)
        v_all = QTensor(c["v"], c["v_scale"], bits)
    else:
        k_all, v_all = c["k"], c["v"]
    q = _proj(h_in, p["wq"], cfg)
    split = _split(p, cfg)
    spec = AttnSpec(causal=True, q_chunk=cfg.q_chunk, split_heads=split)
    h = attention(q, k_all, v_all, spec, cfg.quant, q_offset=qpos,
                  k_positions=kpos)
    # The reference leaves this wo unmarked (its GSPMD program reduces the
    # heads' partial sums all the same, and it never takes the bf16 shard
    # body); a rank holding some heads sums its partial product.
    return dense(_merge(h), p["wo"], cfg.quant, tp="sum", k_split=split)


def _cross_kv(c, cfg: EncDecConfig):
    if _mode(cfg) == "int":
        bits = cfg.quant.kv_bits
        return (QTensor(c["ek"], c["ek_scale"], bits),
                QTensor(c["ev"], c["ev_scale"], bits))
    return c["ek"], c["ev"]


def _dec_stack(params, x, cfg: EncDecConfig, *, enc_x=None, cache=None,
               decode=False):
    """The decoder layers over x; at prefill (``enc_x`` given) each layer's
    self and cross K/V fill ``cache`` when there is one, at decode the
    layers read and write it."""
    layer = remat(_dec_layer, cfg.remat and cache is None)
    for i in range(cfg.n_dec_layers):
        c = None if cache is None else _index(cache["layers"], i)
        x = layer(x, _index(params["dec_layers"], i), cfg, enc_x, c, decode)
    return x


def _dec_layer(x, p, cfg: EncDecConfig, enc_x, c, decode):
    h_in = apply_norm(x, p["ln1"], "layernorm")
    if decode:
        h = _self_attn_decode(h_in, p["self_attn"], c, cfg)
        x = x + h.to(x.dtype)
        h2, _ = _attn(apply_norm(x, p["ln2"], "layernorm"), None,
                      p["cross_attn"], cfg, causal=False,
                      kv_override=_cross_kv(c, cfg))
        x = x + h2.to(x.dtype)
    else:
        h, (sk, sv) = _attn(h_in, h_in, p["self_attn"], cfg, causal=True)
        x = x + h.to(x.dtype)
        h2, (ek, ev) = _attn(apply_norm(x, p["ln2"], "layernorm"), enc_x,
                             p["cross_attn"], cfg, causal=False)
        x = x + h2.to(x.dtype)
        if c is not None:
            _fill_cache(c, sk, sv, ek, ev, cfg)
    return x + _mlp(apply_norm(x, p["ln3"], "layernorm"), p["mlp"],
                    cfg).to(x.dtype)


def init_cache(cfg: EncDecConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """The cache of ``batch`` rows (a rank's shard:
    ``partition.init_cache``)."""
    int_mode = _mode(cfg) == "int"
    dt = torch.int8 if int_mode else cfg.tdtype
    n, h = cfg.n_dec_layers, cfg.n_heads
    z = dict(dtype=dt, device=device)
    lay = {"k": torch.zeros((n, batch, h, max_len, cfg.hd), **z),
           "v": torch.zeros((n, batch, h, max_len, cfg.hd), **z),
           "ek": torch.zeros((n, batch, h, cfg.n_audio_ctx, cfg.hd), **z),
           "ev": torch.zeros((n, batch, h, cfg.n_audio_ctx, cfg.hd), **z),
           "pos": torch.zeros((n,), dtype=torch.int32, device=device)}
    if int_mode:
        for key in ("k_scale", "v_scale", "ek_scale", "ev_scale"):
            lay[key] = torch.ones((n,), dtype=_F32, device=device)
    return {"layers": lay,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def decoder_embed(params, tokens, cfg: EncDecConfig, pos0):
    """Token embeddings plus the sinusoid rows at positions ``pos0 + i``
    (``pos0`` an int or a 0-d device tensor); only those rows are
    computed, each as the reference's 100 000-row table has it."""
    x = embed_lookup(tokens, params["embed"], cfg.tdtype, vocab=cfg.vocab)
    pos = pos0 + torch.arange(tokens.shape[1], dtype=torch.int32,
                              device=x.device)
    return x + _sinusoid_rows(pos, cfg.d_model).to(cfg.tdtype)


def _head(params, x, cfg: EncDecConfig, part):
    """The logits over the whole vocabulary and, partitioned, every row."""
    x = apply_norm(x, params["dec_ln"], "layernorm")
    return _global_logits(params, x, cfg, part)


def loss_fn(params, batch, cfg: EncDecConfig):
    """Teacher-forced NLL of ``batch["labels"]`` (B, S) given
    ``batch["frames"]`` and ``batch["tokens"]``, chunked over the target
    length (the largest chunk <= ``cfg.loss_chunk`` that divides S; the f32
    sums in the reference's order).  Returns (loss, {}).

    Partitioned (modes "float" and "fake"): the global batch in, the rank's
    rows run on its shard of the tree (heads, the MLP's columns, the
    vocabulary rows of the lm_head, whose logits are gathered), and every
    rank returns the global loss; a rank's backward gives its part of each
    gradient, from its own rows, which the train step sums over the batch
    axes (``launch/train.py``)."""
    part = partition.active()
    if part is not None:
        if _mode(cfg) == "int":
            partition.refuse("training in int mode (loss_fn; item 6c.1 "
                             "trains modes 'float' and 'fake')",
                             partition.ROADMAP_ITEM)
        batch = {k: part.batch_rows(v) for k, v in batch.items()}
    partition.check_tree(params, cfg)
    enc_x = encode(params, batch["frames"], cfg)
    x = decoder_embed(params, batch["tokens"], cfg, 0)
    x = apply_norm(_dec_stack(params, x, cfg, enc_x=enc_x), params["dec_ln"],
                   "layernorm")
    return chunked_nll(x, batch["labels"], cfg.loss_chunk,
                       lambda xc: logits_fn(params, xc, cfg)), {}


def prefill(params, batch, cfg: EncDecConfig, max_len: Optional[int] = None):
    """Encode ``batch["frames"]`` (B, n_audio_ctx, d) and run the prompt
    ``batch["tokens"]`` (B, S) into a new cache of ``max_len`` (default S)
    self-attention slots.  Returns (last-position logits (B, 1, V),
    cache).  Partitioned: the global batch in, the global logits out on
    every rank, and the rank's shard of the cache."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    part = partition.active()
    if part is None:
        cache = init_cache(cfg, b, max_len or s, device=tokens.device)
    else:
        cache = partition.init_cache(cfg, b, max_len or s, part.layout,
                                     device=tokens.device)
        batch = {k: part.batch_rows(v) for k, v in batch.items()}
    partition.check_tree(params, cfg)
    enc_x = encode(params, batch["frames"], cfg)
    x = decoder_embed(params, batch["tokens"], cfg, 0)
    x = _dec_stack(params, x, cfg, enc_x=enc_x, cache=cache)
    cache["pos"].fill_(s)
    cache["layers"]["pos"].fill_(s)
    return _head(params, x[:, -1:], cfg, part), cache


def decode_step(params, token, cache, cfg: EncDecConfig):
    """One step: token (B, 1) -> logits (B, 1, V); the cache is updated in
    place (the new self-attention key / value, both ``pos``).
    Partitioned: the global tokens in, the global logits out, the rank's
    shard of the cache."""
    part = partition.active()
    if part is not None:
        token = part.batch_rows(token)
    partition.check_tree(params, cfg)
    x = decoder_embed(params, token, cfg, cache["pos"])
    x = _dec_stack(params, x, cfg, cache=cache, decode=True)
    cache["pos"].add_(1)
    cache["layers"]["pos"].add_(1)
    return _head(params, x, cfg, part), cache
