"""InternVL2-26B: InternViT frontend (a stub: precomputed patch embeddings
prepended to the token embeddings) + InternLM2-20B backbone (48L GQA kv=8)
[arXiv:2404.16821].

Counterpart of ``repro/configs/internvl2_26b.py`` (same widths).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="internvl2-26b", n_layers=48, d_model=6144, n_heads=48, kv_heads=8,
    d_ff=16384, vocab=92553, frontend="patch", n_patches=256)

SMOKE = LMConfig(
    name="internvl2-smoke", n_layers=4, d_model=64, n_heads=4, kv_heads=2,
    d_ff=128, vocab=512, frontend="patch", n_patches=8, dtype="float32",
    q_chunk=16, remat=False)
