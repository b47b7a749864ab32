"""Architecture registry (the ported subset of ``repro/configs/registry.py``):
``get_config`` / ``smoke_config`` for the architectures this port serves."""
from __future__ import annotations

import importlib

ARCHS = {"qwen2.5-32b": "qwen2_5_32b", "deit-s": "deit_s"}


def get_config(arch: str):
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG


def smoke_config(arch: str):
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").SMOKE
