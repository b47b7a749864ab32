"""RecurrentGemma-9B: Griffin hybrid, RG-LRU + local attention 1:2
[arXiv:2402.19427].  Pattern unit (rglru, rglru, local); 38 layers -> 12
full units + 2 remainder rglru layers.  head_dim 256, MQA (kv=1), window
2048.

Counterpart of ``repro/configs/recurrentgemma_9b.py`` (same widths).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
    kv_heads=1, head_dim=256, d_ff=12288, vocab=256_000,
    block_pattern=("rglru", "rglru", "local"), attn_window=2048,
    d_rnn=4096, act="gelu", norm="rmsnorm")

SMOKE = LMConfig(
    name="recurrentgemma-smoke", n_layers=7, d_model=64, n_heads=4,
    kv_heads=1, head_dim=16, d_ff=128, vocab=512,
    block_pattern=("rglru", "rglru", "local"), attn_window=16, d_rnn=64,
    act="gelu", dtype="float32", q_chunk=16, remat=False)
