"""Token embedding with optional int8 row-quantized storage, in PyTorch.
Counterpart of ``repro/layers/embed.py``."""
from __future__ import annotations

import torch


def embed_lookup(tokens, p: dict, dtype=torch.bfloat16):
    tokens = tokens.long()
    if "emb_q" in p:
        rows = p["emb_q"][tokens].to(dtype)
        scale = p["emb_scale"][tokens].to(dtype)
        return rows * scale[..., None]
    return p["emb"][tokens].to(dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    w = torch.randn((vocab, d), generator=gen, device=device) * 0.02
    return {"emb": w.to(dtype)}
