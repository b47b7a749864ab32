"""Phi-3-medium-14B: dense GQA kv=10, RoPE + SwiGLU [arXiv:2404.14219].

Counterpart of ``repro/configs/phi3_medium_14b.py`` (same widths).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
    kv_heads=10, d_ff=17920, vocab=100_352)

SMOKE = LMConfig(
    name="phi3-smoke", n_layers=4, d_model=80, n_heads=4, kv_heads=2,
    d_ff=160, vocab=512, dtype="float32", q_chunk=16, remat=False)
