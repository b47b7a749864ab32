"""Phi-3.5-MoE-42B (6.6B active): 16 experts top-2, GQA kv=8
[hf:microsoft/Phi-3.5-MoE-instruct].

Counterpart of ``repro/configs/phi3_5_moe_42b.py`` (same widths).
"""
from repro_torch.layers.moe import MoEConfig
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    kv_heads=8, d_ff=6400, vocab=32064,
    moe=MoEConfig(n_experts=16, top_k=2))

SMOKE = LMConfig(
    name="phi35moe-smoke", n_layers=4, d_model=64, n_heads=4, kv_heads=2,
    d_ff=128, vocab=512, moe=MoEConfig(n_experts=4, top_k=2),
    dtype="float32", q_chunk=16, remat=False)
