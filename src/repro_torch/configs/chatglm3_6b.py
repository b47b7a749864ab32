"""ChatGLM3-6B: GQA kv=2, 2d-RoPE (half-dim rotary), QKV bias
[arXiv:2406.12793].

Counterpart of ``repro/configs/chatglm3_6b.py`` (same widths).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32, kv_heads=2,
    d_ff=13696, vocab=65024, qkv_bias=True, rotary_frac=0.5)

SMOKE = LMConfig(
    name="chatglm3-smoke", n_layers=4, d_model=64, n_heads=4, kv_heads=2,
    d_ff=128, vocab=512, qkv_bias=True, rotary_frac=0.5, dtype="float32",
    q_chunk=16, remat=False)
