"""End-to-end paper recipe on a CIFAR-shaped task (§V-A, Table II), on the
PyTorch port.

Two-phase QAT of a small DeiT on synthetic class-conditional images (no
dataset is downloaded), then POST-INTEGERIZATION:

  phase 1  last-layer training (head only), LAMB + cosine
  phase 2  full fine-tuning with fake-quant (w/a/attn at --bits)
  final    integerize_params -> integer-only inference on the ``cuda``
           backend (qmatmul and the fused attention kernel on the card);
           the integerized model's accuracy should match the QAT model's
           (the paper's claim: reordering is exact).

Counterpart of ``examples/train_cifar_qat.py``.  Runs on the card unless
``--device cpu`` is given (then the kernels' plain versions run); with no
card it raises.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_cifar_qat \\
          [--steps 150] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.api import QuantConfig, integerize_params
from repro_torch.data.synthetic import image_batch
from repro_torch.launch.train import make_step, require_device
from repro_torch.models import vit
from repro_torch.optim import OptConfig, init_opt_state


@torch.no_grad()
def evaluate(params, cfg, *, steps=8, seed=1000, device="cuda"):
    accs = []
    for i in range(steps):
        b = image_batch(seed + i, batch=64, img=cfg.img_size, device=device)
        logits = vit.forward(params, b["images"], cfg)
        accs.append(float((logits.argmax(-1) == b["labels"])
                          .to(torch.float32).mean()))
    return sum(accs) / len(accs)


def make_vit_step(cfg, ocfg: OptConfig, *, head_only: bool):
    """A training step on ``vit.loss_fn``; ``head_only`` keeps only the
    gradients whose path holds ``head`` (phase 1)."""
    def loss_fn(params, batch):
        return vit.loss_fn(params, batch, cfg)

    return make_step(loss_fn, ocfg, only="head" if head_only else None)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--last-layer-steps", type=int, default=30)
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg_float = vit.ViTConfig(name="deit_tiny_cifar", n_layers=4, d_model=128,
                              n_heads=4, d_ff=256, img_size=32, patch=4,
                              n_classes=10, dtype="float32")
    qc_fake = QuantConfig(w_bits=args.bits, a_bits=args.bits,
                          attn_bits=args.bits, mode="fake")
    cfg_qat = cfg_float.replace(quant=qc_fake)
    ocfg = OptConfig(kind="lamb", lr=5e-4, weight_decay=0.0,   # paper §V-A
                     warmup_steps=10, total_steps=args.steps)

    params = vit.init_params(cfg_float, seed=0, device=dev)
    opt = init_opt_state(params)
    step1 = make_vit_step(cfg_qat, ocfg, head_only=True)
    step2 = make_vit_step(cfg_qat, ocfg, head_only=False)
    for i in range(args.steps):
        batch = image_batch(i, batch=args.batch, img=cfg_float.img_size,
                            device=dev)
        fn = step1 if i < args.last_layer_steps else step2
        params, opt, m = fn(params, opt, batch)
        if i % 25 == 0:
            phase = 1 if i < args.last_layer_steps else 2
            print(f"step {i:4d} (phase {phase}) loss "
                  f"{float(m['loss']):.4f} acc {float(m['acc']):.3f}")

    acc_float = evaluate(params, cfg_float, device=dev)
    acc_qat = evaluate(params, cfg_qat, device=dev)
    qc_int = qc_fake.replace(mode="int", backend="cuda")
    iparams = integerize_params(params, qc_int)
    acc_int = evaluate(iparams, cfg_float.replace(quant=qc_int), device=dev)

    print(f"\n== results ({args.bits}-bit, {dev}) ==")
    print(f"float inference of QAT weights : {acc_float:.3f}")
    print(f"fake-quant (QAT graph)         : {acc_qat:.3f}")
    print(f"integerized (int-only graph)   : {acc_int:.3f}")
    print("paper claim check: |int - qat| =", f"{abs(acc_int - acc_qat):.3f}",
          "(should be ~0: reordering is exact)")
    return {"acc_float": acc_float, "acc_qat": acc_qat, "acc_int": acc_int}


if __name__ == "__main__":
    main()
