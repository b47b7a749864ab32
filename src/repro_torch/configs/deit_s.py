"""DeiT-S — the paper's own model (Table I/II): 12L, d=384, 6H, N=198.

Counterpart of ``repro/configs/deit_s.py`` (same widths).
"""
from repro_torch.models.vit import ViTConfig

CONFIG = ViTConfig(name="deit_s", n_layers=12, d_model=384, n_heads=6,
                   d_ff=1536, img_size=224, patch=16, n_classes=10)

# CIFAR-native variant (32x32, patch 4).
CIFAR = ViTConfig(name="deit_cifar", n_layers=6, d_model=192, n_heads=6,
                  d_ff=768, img_size=32, patch=4, n_classes=10)

SMOKE = ViTConfig(name="deit-smoke", n_layers=2, d_model=64, n_heads=4,
                  d_ff=128, img_size=32, patch=8, n_classes=10)
