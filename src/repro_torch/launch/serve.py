"""Serving entry point: a thin CLI over the continuous-batching paged engine.

Counterpart of ``repro/launch/serve.py`` (``python -m repro.launch.serve``)
with the same flags, plus ``--backend cuda|torch`` (the CUDA kernels or
the plain PyTorch path) and ``--device`` (``cuda`` by default; the CPU
runs only when asked for, and then every kernel wrapper runs its plain
version).  The serving graph is the paper's: low-bit weight codes,
integer matmuls with reordered dequantization, a low-bit paged KV cache
read in place by the paged decode kernel, base-2 embedded softmax.

Requests with ragged prompt lengths flow through
:class:`repro_torch.launch.engine.PagedEngine`, for every decoder-only LM
of the registry (``--arch``, its SMOKE config), the recurrent families
included; an encoder-decoder (Whisper) is refused with a pointer to
``models/encdec.py``, where the reference's CLI fails on it.
``--shared-prefix N`` declares a common N-token prefix as a cache
breakpoint (prefilled once, pages aliased).  ``--prefill-chunk`` /
``--prefill-budget`` engage the chunked-prefill token-budget scheduler.
The report always carries the dispatch STATS and the kernels' launch
counts — the evidence that the serving graph really ran on the kernels —
and the device it ran on; ``--json`` emits it as one JSON object.

Failure handling: the loop installs the
:mod:`repro_torch.runtime.preemption` SIGTERM/SIGUSR1 handlers (and puts
the previous ones back when it returns) and polls ``should_stop()`` every
engine step; on a signal it releases in-flight rows with their partial
outputs kept, emits the report flagged ``"preempted": true`` and exits
with ``PREEMPTED_EXIT_CODE``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.api import QuantConfig, integerize_params
from repro_torch.kernels import dispatch
from repro_torch.launch.engine import PagedEngine, Request
from repro_torch.models import lm
from repro_torch.runtime import preemption

_FAILURE_KEYS = ("preemptions", "resumes", "cancelled", "expired",
                 "watchdog_fires", "audit_failures", "forced_xla_steps",
                 "quarantined")

_EPILOG = """\
failure handling:
  SIGTERM / SIGUSR1   graceful drain: stop admitting, release in-flight
                      rows keeping their partial outputs, emit the final
                      report with "preempted": true, exit with code 42.
  pool pressure       victim preemption with bit-exact resume: the evicted
                      request re-enters admission as a recompute and its
                      resumed tokens are bit-identical to an uninterrupted
                      run (capped backoff, terminal rejection after
                      repeated preemption).
  --deadline-s        queued requests past the deadline expire instead of
                      stalling decode behind an unservable queue.
  --audit-every N     engine-wide invariant audit (page conservation,
                      refcounts vs. registry pins, scale-pool health)
                      every N steps; failures are counted in the report's
                      "failures" section, never fatal in serving.
"""


def device_info(device) -> dict:
    """What the run ran on: the card's name and count, or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def staggered_prompts(n_req: int, prompt_len: int, vocab: int,
                      shared_prefix: int = 0, seed: int = 0):
    """The CLI's request mix: staggered prompt lengths up to
    ``prompt_len`` (the multi-tenant regime the paged cache is for),
    optionally behind a common ``shared_prefix``-token system prompt."""
    rng = np.random.RandomState(seed)
    lens = [max(1, prompt_len - (i * prompt_len) // (2 * n_req))
            for i in range(n_req)]
    prompts = [rng.randint(0, vocab, n).astype(np.int32) for n in lens]
    if shared_prefix:
        sys_prompt = rng.randint(0, vocab, shared_prefix).astype(np.int32)
        prompts = [np.concatenate([sys_prompt, p]) for p in prompts]
    return prompts


def serve(cfg: lm.LMConfig, params, prompts, *, gen_tokens: int = 16,
          max_len: int | None = None, page_size: int = 16,
          eos_id: int | None = None, batch_size: int | None = None,
          prefix_len: int = 0, deadline_s: float | None = None,
          audit_every: int = 0, preempt_after_step: int | None = None,
          prefill_chunk: int | None = None,
          prefill_budget: int | None = None,
          preempt_after_steps: int = 8):
    """prompts: (B, S) int32 (or a list of ragged 1-D prompts) ->
    (generated (B, gen_tokens) int32, stats).

    Runs the continuous-batching engine; with equal-length prompts and no
    EOS this reproduces the old lockstep loop, but rows finish (and new
    work is admitted) independently.  ``prefix_len`` declares a shared
    cache breakpoint on every request (system-prompt traffic): requests
    whose leading ``prefix_len`` tokens agree alias the same refcounted
    physical pages and prefill that prefix ONCE.

    The step loop polls :func:`repro_torch.runtime.preemption.should_stop`
    (SIGTERM/SIGUSR1 when the CLI installed the handlers): on a signal
    the engine shuts down gracefully — queued requests are preempted
    unserved, in-flight rows keep their partial outputs — and the stats
    carry ``preempted: True``.  ``preempt_after_step`` trips the same
    path from inside the loop at a fixed step (deterministic
    graceful-shutdown testing without racing a real signal).

    ``prefill_chunk`` / ``prefill_budget`` engage the chunked-prefill
    token-budget scheduler (engine module docstring): prompts prefill in
    page-aligned chunks and each engine step spends at most
    ``prefill_budget`` prompt tokens on prefill, so a burst of arrivals
    never stalls running decodes for a whole prompt.  The cut plan is
    canonical — chunking changes WHEN chunks launch, never the tokens.

    ``preempt_after_steps`` is the engine's equal-priority starvation
    threshold (the reference's default, 8).  With more requests than rows
    and ``gen_tokens`` above it, equal-priority requests preempt each other
    until ``max_preemptions`` rejects some (ROADMAP queue 3); a caller that
    wants every request served raises it above ``gen_tokens``.
    """
    if hasattr(prompts, "shape"):
        prompts = [np.asarray(prompts[i], np.int32)
                   for i in range(prompts.shape[0])]
    lens = [len(p) for p in prompts]
    max_len = max_len or (max(lens) + gen_tokens)
    bucket = max(lens)
    buckets = {bucket}
    if prefill_chunk is not None or prefill_budget is not None:
        # a bucket sized to the chunk keeps chunk launches unpadded
        c = prefill_chunk if prefill_chunk is not None else prefill_budget
        buckets.add(max(page_size, min(c, bucket) // page_size * page_size))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=gen_tokens,
                    eos_id=eos_id, prefix_len=prefix_len,
                    deadline_s=deadline_s)
            for i, p in enumerate(prompts)]

    t0 = time.perf_counter()
    engine = PagedEngine(cfg, params, batch_size=batch_size or len(reqs),
                         max_len=max_len, page_size=page_size,
                         prefill_buckets=tuple(sorted(buckets)),
                         prefill_chunk=prefill_chunk,
                         prefill_budget=prefill_budget,
                         audit_every=audit_every, audit_raises=False,
                         preempt_after_steps=preempt_after_steps)
    for r in reqs:
        engine.submit(r)
    preempted = False
    while True:
        if preemption.should_stop() or (
                preempt_after_step is not None
                and engine.step_count >= preempt_after_step):
            engine.shutdown()
            preempted = True
            break
        if not engine.step():
            break
    total_s = time.perf_counter() - t0

    gen = np.zeros((len(reqs), gen_tokens), np.int32)
    for i, r in enumerate(reqs):
        gen[i, :len(r.tokens)] = r.tokens
    n_tok = sum(len(r.tokens) for r in reqs)
    decode_s = sum(r.decode_s for r in reqs) / max(len(reqs), 1)
    snap = dispatch.snapshot()
    return gen, {
        "total_s": total_s,
        "prefill_s": total_s - decode_s,
        "decode_s": decode_s,
        "tok_per_s": n_tok / max(total_s, 1e-9),
        "per_seq": [{"rid": r.rid, "prompt_len": len(r.prompt),
                     "gen": len(r.tokens),
                     "status": r.status,
                     "admitted_step": r.admitted_step,
                     "finished_step": r.finished_step,
                     "tok_per_s": r.tok_per_s,
                     "error": r.error} for r in reqs],
        "engine_steps": engine.step_count,
        "prefill_calls": engine.prefill_calls,
        "prefill_chunks": engine.prefill_chunks,
        "prefill_tokens": engine.prefill_tokens,
        "prefix_prefills": engine.prefix_prefills,
        "shared_prefix_hits": engine.shared_prefix_hits,
        "registered_prefixes": len(engine.prefix_registry),
        "rejected": len(engine.rejected),
        "preempted": preempted,
        "failures": {k: snap[k] for k in _FAILURE_KEYS},
        "audit_violations": list(engine.violations),
        "dispatch": snap,
        "kernel_launches": dispatch.launch_counts(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=_EPILOG)
    ap.add_argument("--arch", default="qwen2.5-32b",
                    help="a decoder-only LM of the registry, served at its "
                         "SMOKE config: the attention families and the "
                         "recurrent ones (recurrentgemma-9b, mamba2-130m)")
    ap.add_argument("--mode", choices=["int", "float"], default="int")
    ap.add_argument("--backend", choices=["cuda", "torch"], default=None,
                    help="kernel backend for the int serving graph "
                         "(default: cuda)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--wbits", type=int, default=4)
    ap.add_argument("--kv-bits", type=int, default=8, choices=[4, 8])
    ap.add_argument("--batch", type=int, default=4,
                    help="decode batch rows (continuous batching admits "
                         "more requests than rows as they free up)")
    ap.add_argument("--requests", type=int, default=None,
                    help="number of requests (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="max prompt length; requests get staggered "
                         "lengths up to this")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common system prompt of this many "
                         "tokens to every request and declare it as a "
                         "cache breakpoint (prefilled once, pages aliased)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill prompts in page-aligned chunks of this "
                         "many tokens (chunked-prefill scheduler)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="max prompt tokens prefilled per engine step "
                         "(floor of one chunk per step)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="expire requests still queued after this many "
                         "wall seconds (TIMED_OUT, never stalls decode)")
    ap.add_argument("--audit-every", type=int, default=32,
                    help="run the engine-wide invariant audit every N "
                         "steps (0 disables; failures are counted in the "
                         "report, not fatal)")
    ap.add_argument("--preempt-after-step", type=int, default=None,
                    help="trip the graceful-shutdown path (as if SIGUSR1 "
                         "arrived) once the engine reaches this step")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object on stdout")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import is_encdec, smoke_config
    cfg = smoke_config(args.arch)
    if is_encdec(cfg):
        raise SystemExit(
            f"{args.arch} is an encoder-decoder model; the paged engine "
            f"serves decoder-only LMs. Generate with "
            f"repro_torch.models.encdec (models/encdec.py: prefill, "
            f"decode_step).")
    params = lm.init_params(cfg, seed=0, device=args.device)
    qc = None
    if args.mode == "int":
        qc = QuantConfig(w_bits=args.wbits, a_bits=8, attn_bits=7,
                         kv_bits=args.kv_bits, mode="int",
                         backend=args.backend)
        params = integerize_params(params, qc)
        cfg = cfg.replace(quant=qc)
    n_req = args.requests or args.batch
    prompts = staggered_prompts(n_req, args.prompt_len, cfg.vocab,
                                args.shared_prefix)
    dispatch.reset_stats()
    dispatch.reset_launches()
    preemption.reset()
    previous = preemption.install()
    try:
        toks, stats = serve(cfg, params, prompts, gen_tokens=args.gen,
                            page_size=args.page_size, eos_id=args.eos_id,
                            batch_size=args.batch,
                            prefix_len=args.shared_prefix,
                            deadline_s=args.deadline_s,
                            audit_every=args.audit_every,
                            preempt_after_step=args.preempt_after_step,
                            prefill_chunk=args.prefill_chunk,
                            prefill_budget=args.prefill_budget)
    finally:
        preemption.restore(previous)
        preemption.reset()
    backend = dispatch.resolve_backend(qc) if qc is not None else None
    report = {"mode": args.mode, "backend": backend,
              "device": device_info(args.device),
              "sample": toks[0, :12].tolist(), **stats}
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        flag = "  PREEMPTED (partial)" if stats["preempted"] else ""
        print(f"[serve:{args.mode}:{backend}] on {report['device']['kind']}"
              f"  total {stats['total_s']:.3f}s  "
              f"decode {stats['decode_s']:.3f}s  "
              f"{stats['tok_per_s']:.1f} tok/s  "
              f"steps {stats['engine_steps']}  "
              f"prefills {stats['prefill_calls']}  "
              f"(chunks {stats['prefill_chunks']}, "
              f"tokens {stats['prefill_tokens']}, "
              f"prefix {stats['prefix_prefills']}, "
              f"hits {stats['shared_prefix_hits']})  "
              f"rejected {stats['rejected']}{flag}")
        for s in stats["per_seq"]:
            tail = f"{s['status'].upper()}: {s['error']}" if s["error"] \
                else f"{s['status']}  {s['tok_per_s']:.1f} tok/s"
            print(f"  [seq {s['rid']}] prompt {s['prompt_len']:4d}  "
                  f"gen {s['gen']:3d}  admitted@{s['admitted_step']}  "
                  f"finished@{s['finished_step']}  {tail}")
        print("[failures] " + "  ".join(
            f"{k}={v}" for k, v in stats["failures"].items()))
        print("[dispatch] " + "  ".join(
            f"{k}={v}" for k, v in stats["dispatch"].items()
            if not isinstance(v, dict) and k not in _FAILURE_KEYS))
        print("[launches] " + "  ".join(
            f"{k}={v}" for k, v in stats["kernel_launches"].items()))
        for k, v in sorted(stats["dispatch"].get("blocks", {}).items()):
            print(f"[blocks] {k} -> {v}")
        print("sample:", toks[0, :12].tolist())
    if stats["preempted"]:
        raise SystemExit(preemption.PREEMPTED_EXIT_CODE)


if __name__ == "__main__":
    main()
