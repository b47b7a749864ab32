"""Whisper-large-v3 backbone: 32 encoder + 32 decoder layers, d 1280, 20
heads MHA; the conv / mel frontend is a stub (``input_specs`` gives frame
embeddings) [arXiv:2212.04356].

Counterpart of ``repro/configs/whisper_large_v3.py`` (same widths).
"""
from repro_torch.models.encdec import EncDecConfig

CONFIG = EncDecConfig(
    name="whisper-large-v3", n_enc_layers=32, n_dec_layers=32, d_model=1280,
    n_heads=20, d_ff=5120, vocab=51866, n_audio_ctx=1500)

SMOKE = EncDecConfig(
    name="whisper-smoke", n_enc_layers=2, n_dec_layers=2, d_model=64,
    n_heads=4, d_ff=128, vocab=256, n_audio_ctx=16, dtype="float32",
    q_chunk=16, remat=False)
