"""Architecture registry (the ported subset of ``repro/configs/registry.py``):
``get_config`` / ``smoke_config`` for the architectures this port serves."""
from __future__ import annotations

import importlib

ARCHS = {
    "qwen2.5-32b": "qwen2_5_32b",
    "chatglm3-6b": "chatglm3_6b",
    "yi-34b": "yi_34b",
    "phi3-medium-14b": "phi3_medium_14b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "internvl2-26b": "internvl2_26b",
    "deit-s": "deit_s",
}


def get_config(arch: str):
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG


def smoke_config(arch: str):
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").SMOKE
