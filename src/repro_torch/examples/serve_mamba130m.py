"""Serve the full-size Mamba2-130M (the assigned config, about 130M
parameters) to a batch of requests, integerized: 4-bit weights, int8
activations, integer matmuls with reordered dequantization.  The SSD
recurrence keeps a state per layer instead of a KV cache.

Counterpart of ``examples/serve_mamba130m.py``.  Weights are random from a
seed.  Runs on the card by default, where every integer linear goes
through the qmatmul kernel (the launch counts are printed); ``--device
cpu`` runs the kernels' plain versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_mamba130m \\
          [--gen 12] [--batch 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.api import (QuantConfig, count_params,
                                  integerize_params, model_bytes)
from repro_torch.kernels import dispatch
from repro_torch.models import lm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--wbits", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_config("mamba2-130m").replace(dtype="float32")
    print("initializing mamba2-130m ...")
    params = lm.init_params(cfg, seed=0, device=dev)
    n = count_params(params)
    qc = QuantConfig(w_bits=args.wbits, a_bits=8, attn_bits=7, mode="int")
    iparams = integerize_params(params, qc)
    cfg_i = cfg.replace(quant=qc)
    mb_f = model_bytes(params, None) / 1e6
    mb_i = model_bytes(iparams, qc) / 1e6
    print(f"params: {n / 1e6:.0f}M | storage: {mb_f:.0f} MB float -> "
          f"{mb_i:.0f} MB integerized")
    del params

    gen = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(iparams, {"tokens": prompts}, cfg_i,
                               max_len=args.prompt_len)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    print(f"prefill({args.batch}x{args.prompt_len}): {t_prefill:.2f}s")

    outs = []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        outs.append(tok)
        logits, cache = lm.decode_step(iparams, tok, cache, cfg_i)
        tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(dev)
    dt = time.perf_counter() - t0
    tokens = torch.cat(outs, dim=1).cpu()
    launches = dispatch.launch_counts()
    print(f"decode: {args.gen} tokens x {args.batch} requests in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s on {dev}; SSM state "
          f"instead of a KV cache)")
    print("sample continuation:", tokens[0].tolist())
    print(f"kernel launches {launches}")
    return {"tokens": tokens, "prefill_s": t_prefill, "decode_s": dt,
            "pos": int(cache["pos"]), "launches": launches,
            "finite": bool(torch.isfinite(logits).all()),
            "mb_float": mb_f, "mb_int": mb_i}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    main()
