"""Architecture registry, the assigned input shapes and abstract input
specs.  Counterpart of ``repro/configs/registry.py``: every (arch x shape)
cell maps to a step kind and a dict of shape-only tensors (``device="meta"``
in place of JAX's ``ShapeDtypeStruct``), so a caller can size a run without
allocating anything."""
from __future__ import annotations

import importlib

import torch

ARCHS = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2.5-32b": "qwen2_5_32b",
    "chatglm3-6b": "chatglm3_6b",
    "yi-34b": "yi_34b",
    "phi3-medium-14b": "phi3_medium_14b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "internvl2-26b": "internvl2_26b",
    "mamba2-130m": "mamba2_130m",
    "whisper-large-v3": "whisper_large_v3",
    "deit-s": "deit_s",
}

# Assigned shape sets: (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# Sub-quadratic attention requirement: long_500k runs only on SSM/hybrid.
LONG_OK = {"recurrentgemma-9b", "mamba2-130m"}


def get_config(arch: str):
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG


def smoke_config(arch: str):
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").SMOKE


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return False, "needs sub-quadratic attention (full-attn arch; skip per DESIGN.md)"
    if arch == "deit-s" and shape != "train_4k":
        return False, "paper's own encoder-only arch (bench'd separately)"
    return True, ""


def is_encdec(cfg) -> bool:
    return hasattr(cfg, "n_enc_layers")


def _spec(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape: str, cfg=None, *, seq=None, batch=None):
    """Returns (kind, batch_specs): shape-only inputs of the step function,
    kind in {"train", "prefill", "decode"}; a decode step's cache is the
    caller's (it depends on the quant mode).  ``seq`` and ``batch`` stand
    in for the shape's own length and global batch (a cell cut to size)."""
    cfg = cfg or get_config(arch)
    seq0, gb0, kind = SHAPES[shape]
    seq, gb = seq or seq0, batch or gb0

    if is_encdec(cfg):
        frames = _spec((gb, cfg.n_audio_ctx, cfg.d_model), torch.float32)
        if kind == "train":
            return kind, {"frames": frames, "tokens": _spec((gb, seq)),
                          "labels": _spec((gb, seq))}
        if kind == "prefill":
            return kind, {"frames": frames, "tokens": _spec((gb, seq))}
        return kind, {"token": _spec((gb, 1))}

    if kind in ("train", "prefill"):
        n_tok = seq - cfg.n_patches if cfg.frontend == "patch" else seq
        specs = {"tokens": _spec((gb, n_tok))}
        if kind == "train":
            specs["labels"] = _spec((gb, n_tok))
        if cfg.frontend == "patch":
            specs["patches"] = _spec((gb, cfg.n_patches, cfg.d_model),
                                     torch.float32)
        return kind, specs
    return kind, {"token": _spec((gb, 1))}
