"""Qwen2.5-32B: dense GQA with QKV bias [hf:Qwen/Qwen2.5].

Counterpart of ``repro/configs/qwen2_5_32b.py`` (same widths).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40, kv_heads=8,
    d_ff=27648, vocab=152_064, qkv_bias=True, rope_theta=1e6)

SMOKE = LMConfig(
    name="qwen2.5-smoke", n_layers=4, d_model=64, n_heads=4, kv_heads=2,
    d_ff=128, vocab=512, qkv_bias=True, dtype="float32", q_chunk=16,
    remat=False)
