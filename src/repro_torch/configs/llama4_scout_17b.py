"""Llama-4-Scout-17B-16E: MoE 16 experts top-1 + shared expert, GQA kv=8
[hf:meta-llama/Llama-4-Scout-17B-16E].

Counterpart of ``repro/configs/llama4_scout_17b.py`` (same widths).
"""
from repro_torch.layers.moe import MoEConfig
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    kv_heads=8, d_ff=8192, vocab=202_048,
    moe=MoEConfig(n_experts=16, top_k=1, shared_expert=True))

SMOKE = LMConfig(
    name="llama4-smoke", n_layers=4, d_model=64, n_heads=4, kv_heads=2,
    d_ff=128, vocab=512, moe=MoEConfig(n_experts=4, top_k=1,
                                       shared_expert=True),
    dtype="float32", q_chunk=16, remat=False)
