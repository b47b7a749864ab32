"""Yi-34B: llama-arch dense GQA [arXiv:2403.04652].

Counterpart of ``repro/configs/yi_34b.py`` (same widths).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, kv_heads=8,
    d_ff=20480, vocab=64000, rope_theta=5e6)

SMOKE = LMConfig(
    name="yi-smoke", n_layers=4, d_model=64, n_heads=8, kv_heads=2,
    d_ff=128, vocab=512, dtype="float32", q_chunk=16, remat=False)
