"""Mamba2-130M: attention-free SSD (state-space duality), ssm_state=128
[arXiv:2405.21060].  The paper's integer QK^T / softmax do not apply
(attention-free); its reordered integer linears do.

Counterpart of ``repro/configs/mamba2_130m.py`` (same widths).
"""
from repro_torch.layers.ssd import SSDConfig
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="mamba2-130m", n_layers=24, d_model=768, n_heads=1, kv_heads=1,
    d_ff=0, vocab=50280, block_pattern=("ssd",),
    ssd=SSDConfig(d_state=128, head_dim=64, expand=2, chunk=128))

SMOKE = LMConfig(
    name="mamba2-smoke", n_layers=4, d_model=64, n_heads=1, kv_heads=1,
    d_ff=0, vocab=512, block_pattern=("ssd",),
    ssd=SSDConfig(d_state=16, head_dim=16, expand=2, chunk=8),
    dtype="float32", q_chunk=16, remat=False)
