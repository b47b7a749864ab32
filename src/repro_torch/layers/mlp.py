"""Feed-forward blocks (SwiGLU / GELU) over the quantized dense entry
point, in PyTorch.  Counterpart of ``repro/layers/mlp.py``."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.core.api import QuantConfig, dense


def mlp(x, p: dict, cfg: QuantConfig | None, *, act: str = "swiglu"):
    if act == "swiglu":
        h = F.silu(dense(x, p["gate"], cfg)) * dense(x, p["up"], cfg)
    elif act == "gelu":
        h = F.gelu(dense(x, p["up"], cfg), approximate="tanh")
    else:
        raise ValueError(act)
    return dense(h.to(x.dtype), p["down"], cfg)
