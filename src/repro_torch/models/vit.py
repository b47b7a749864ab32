"""ViT / DeiT-S — the paper's own model, in PyTorch.

Counterpart of ``repro/models/vit.py``.  DeiT-S: 12 layers, d = 384, 6
heads, MLP 4x, LayerNorm, GELU, cls + distillation tokens (N = 196 + 2 =
198 at 224 x 224 / patch 16).  ``cfg.quant.mode == "int"`` runs the
integerized graph: every linear but the float ``head`` on the qmatmul
kernel (the patch embedding's (B, 196, 768) activations calibrate per
image through the kernel's per-row epilogue scale) and attention on the
fused kernel, non-causal (``dispatch`` picks its blocks: at N = 198 one
query chunk, bq = 33, bk = 224).  The parameter tree is the reference's:
``layers`` stacked along a leading axis of length ``n_layers``, so a tree
made by the JAX package crosses over through ``repro_torch.interop``.
``loss_fn`` is the training loss (the fake graph of ``cfg.quant.mode ==
"fake"`` trains through autograd); ``cfg.remat`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``, with grad enabled only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.api import QuantConfig, dense
from repro_torch.layers.attention import AttnSpec, attention
from repro_torch.layers.mlp import mlp
from repro_torch.layers.norms import apply_norm, init_norm
from repro_torch.models.scan_util import remat, scan


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str = "deit_s"
    n_layers: int = 12
    d_model: int = 384
    n_heads: int = 6
    d_ff: int = 1536
    img_size: int = 224
    patch: int = 16
    channels: int = 3
    n_classes: int = 10
    distill_token: bool = True
    dtype: str = "float32"
    quant: Optional[QuantConfig] = None
    q_chunk: int = 256
    remat: bool = False

    @property
    def n_patches(self):
        return (self.img_size // self.patch) ** 2

    @property
    def n_tokens(self):
        return self.n_patches + 1 + int(self.distill_token)

    @property
    def hd(self):
        return self.d_model // self.n_heads

    @property
    def tdtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _lin(gen, lead, din, dout, dtype, device):
    w = torch.randn((*lead, din, dout), generator=gen, device=device)
    return {"w": (w * din ** -0.5).to(dtype),
            "b": torch.zeros((*lead, dout), dtype=dtype, device=device)}


def init_params(cfg: ViTConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random weights from a torch generator seeded with ``seed``, made on
    ``device``, in the reference's tree layout."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, dt, lead = cfg.d_model, cfg.tdtype, (cfg.n_layers,)
    patch_dim = cfg.patch * cfg.patch * cfg.channels
    n_extra = 1 + int(cfg.distill_token)

    def norm():
        return {k: v.expand(*lead, *v.shape).clone()
                for k, v in init_norm(d, "layernorm", device=device).items()}

    layers = {"ln1": norm(),
              "attn": {n: _lin(gen, lead, d, d, dt, device)
                       for n in ("wq", "wk", "wv", "wo")},
              "ln2": norm(),
              "mlp": {"up": _lin(gen, lead, d, cfg.d_ff, dt, device),
                      "down": _lin(gen, lead, cfg.d_ff, d, dt, device)}}
    pos = torch.randn((cfg.n_tokens, d), generator=gen, device=device)
    return {"patch": _lin(gen, (), patch_dim, d, dt, device),
            "cls": torch.zeros((n_extra, d), dtype=dt, device=device),
            "pos_emb": (pos * 0.02).to(dt),
            "layers": layers,
            "final_ln": init_norm(d, "layernorm", device=device),
            "head": _lin(gen, (), d, cfg.n_classes, dt, device)}


def patchify(images, cfg: ViTConfig):
    """(B, H, W, C) -> (B, n_patches, patch * patch * C)."""
    b, h, w, c = images.shape
    p = cfg.patch
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def embed(params, images, cfg: ViTConfig):
    """Patch embedding, then the cls (and distillation) tokens and the
    position embedding: the residual stream entering layer 0."""
    x = dense(patchify(images.to(cfg.tdtype), cfg), params["patch"],
              cfg.quant)
    b = x.shape[0]
    extra = params["cls"].expand(b, *params["cls"].shape)
    return torch.cat([extra, x], dim=1) + params["pos_emb"]


def block(x, p, cfg: ViTConfig):
    """One encoder layer (``p``: that layer's slice of ``params["layers"]``)
    on the residual stream ``x`` (B, tokens, d_model)."""
    spec = AttnSpec(causal=False, q_chunk=cfg.q_chunk)
    h = apply_norm(x, p["ln1"], "layernorm")
    bb, s, d = h.shape

    def proj(pp):
        return dense(h, pp, cfg.quant).reshape(
            bb, s, cfg.n_heads, cfg.hd).transpose(1, 2)

    out = attention(proj(p["attn"]["wq"]), proj(p["attn"]["wk"]),
                    proj(p["attn"]["wv"]), spec, cfg.quant)
    out = out.transpose(1, 2).reshape(bb, s, d)
    x = x + dense(out, p["attn"]["wo"], cfg.quant)
    return x + mlp(apply_norm(x, p["ln2"], "layernorm"), p["mlp"],
                   cfg.quant, act="gelu")


def head(params, x, cfg: ViTConfig):
    """Final LayerNorm, the cls/distill-token average, the float head."""
    x = apply_norm(x, params["final_ln"], "layernorm")
    n_extra = 1 + int(cfg.distill_token)
    pooled = x[:, :n_extra].mean(dim=1)
    return dense(pooled, params["head"], None).to(torch.float32)


def forward(params, images, cfg: ViTConfig):
    """-> (B, n_classes) f32 logits (cls/distill-token average, DeiT
    eval)."""
    layer = remat(block, cfg.remat)
    x, _ = scan(lambda x, p: (layer(x, p, cfg), None),
                embed(params, images, cfg), params["layers"])
    return head(params, x, cfg)


def loss_fn(params, batch, cfg: ViTConfig):
    logits = forward(params, batch["images"], cfg)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, {"acc": acc}
