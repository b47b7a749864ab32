"""Quickstart: the paper's integerization, on the PyTorch port.

1. Eq.1 == Eq.2: the reordered integer linear matches dequantize-first.
2. The model-size shrink at low-bit weights.
3. Serve a small LM integerized (integer matmuls, base-2 softmax, int8
   ring KV cache) beside its float baseline: prefill logits' correlation,
   then greedy continuations over the ring.

Counterpart of ``examples/quickstart.py``.  Weights are random from a
seed.  Runs on the card by default, where the integer model goes through
the CUDA kernels (the launch counts are printed); ``--device cpu`` runs
the kernels' plain versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import integerize, quant
from repro_torch.core.api import QuantConfig, integerize_params, model_bytes
from repro_torch.kernels import dispatch
from repro_torch.models import lm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # --- Eq.1 vs Eq.2 on a single linear -------------------------------
    x = torch.randn((4, 64), generator=gen, device=dev)
    w = torch.randn((64, 32), generator=gen, device=dev) * 0.2
    b = torch.randn((32,), generator=gen, device=dev) * 0.1
    p = integerize.make_qlinear(w.T, b, 3)              # 3-bit weights
    xq = quant.quantize_tensor(x, 8)
    y_reordered = integerize.int_linear(xq, p)          # Eq.2: int MACs
    y_dequant_first = integerize.dequant_linear_ref(xq, p)  # Eq.1 oracle
    err = float((y_reordered - y_dequant_first).abs().max())
    print(f"[1] operand reordering exactness: max |Eq.2 - Eq.1| = {err:.2e}")

    # --- Whole-model integerized serving --------------------------------
    cfg_f = lm.LMConfig(name="demo", n_layers=4, d_model=128, n_heads=4,
                        kv_heads=2, d_ff=256, vocab=512, dtype="float32",
                        q_chunk=32)
    params = lm.init_params(cfg_f, seed=0, device=dev)
    # 8-bit here shows near-exact parity on an untrained net; low-bit
    # (2-4b) needs the QAT recipe first (the training slice).
    qc = QuantConfig(w_bits=8, a_bits=8, attn_bits=7, mode="int")
    iparams = integerize_params(params, qc)
    cfg_i = cfg_f.replace(quant=qc)
    mb_f = model_bytes(params, None) / 1e6
    mb_i = model_bytes(iparams, qc) / 1e6
    print(f"[2] model size: {mb_f:.1f} MB float -> {mb_i:.1f} MB at "
          f"{qc.w_bits}-bit weights")

    dispatch.reset_launches()
    prompts = torch.randint(0, cfg_f.vocab, (2, 16), generator=gen,
                            device=dev, dtype=torch.int32)
    lf, cf = lm.prefill(params, {"tokens": prompts}, cfg_f, max_len=24)
    li, ci = lm.prefill(iparams, {"tokens": prompts}, cfg_i, max_len=24)
    corr = float(torch.corrcoef(torch.stack([lf.flatten(),
                                             li.flatten()]))[0, 1])
    print(f"[3] integerized vs float prefill logits corr = {corr:.4f}")

    tok = torch.argmax(lf, -1).to(torch.int32)
    out_f, out_i = [], []
    for _ in range(8):
        lf, cf = lm.decode_step(params, tok, cf, cfg_f)
        li, ci = lm.decode_step(iparams, tok, ci, cfg_i)
        out_f.append(int(torch.argmax(lf[0])))
        out_i.append(int(torch.argmax(li[0])))
        tok = torch.argmax(lf, -1).to(torch.int32)
    kv_dtype = ci["units"]["b0"]["k"].dtype
    launches = dispatch.launch_counts()
    print(f"[4] greedy continuation  float: {out_f}")
    print(f"    greedy continuation  int:   {out_i}")
    print(f"    KV cache dtype: {kv_dtype} (int8 quantized ring cache); "
          f"on {dev}, kernel launches {launches}")
    return {"eq_err": err, "mb_float": mb_f, "mb_int": mb_i, "corr": corr,
            "tokens_float": out_f, "tokens_int": out_i,
            "kv_dtype": str(kv_dtype), "launches": launches}


if __name__ == "__main__":
    main()
