"""Token embedding with optional int8 row-quantized storage, in PyTorch.
Counterpart of ``repro/layers/embed.py``."""
from __future__ import annotations

import torch

from repro_torch.distributed import partition


def embed_lookup(tokens, p: dict, dtype=torch.bfloat16, vocab=None):
    """Rows of ``tokens``.  ``vocab``: the model's vocabulary; a table
    with fewer rows is this rank's block of a vocabulary split over
    "model" (partitioned rules): other ranks' tokens look up zeros here,
    and the sum over "model", one non-zero term an element, is the
    lookup, exactly.  Its backward is the identity, so each rank's table
    gets the gradient of its own rows."""
    tokens = tokens.long()
    table = p["emb_q"] if "emb_q" in p else p["emb"]
    n = table.shape[0]
    part = partition.active() if vocab is not None and n != vocab else None
    if part is not None:
        tokens = tokens - part.j * n
        hit = (tokens >= 0) & (tokens < n)
        tokens = tokens.clamp(0, n - 1)
    if "emb_q" in p:
        rows = p["emb_q"][tokens].to(dtype)
        scale = p["emb_scale"][tokens].to(dtype)
        x = rows * scale[..., None]
    else:
        x = p["emb"][tokens].to(dtype)
    if part is None:
        return x
    return part.sum(torch.where(hit[..., None], x, 0))


def init_embed(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    w = torch.randn((vocab, d), generator=gen, device=device) * 0.02
    return {"emb": w.to(dtype)}
