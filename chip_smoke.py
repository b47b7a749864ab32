"""Run the PyTorch port's main path on one NVIDIA GPU and hold every CUDA
kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit (``nvidia-smi``), the device
   name and count seen by torch;
2. build: every ``src/repro_torch/csrc/*.cu`` with ``nvcc`` (all started at
   once), printing ``-Xptxas -v``;
3. check: each kernel against its plain version on the card at main-path
   shapes — qmatmul exactly (int8 and packed bodies, M = 4 and 256, every
   (N, K) of one Qwen2.5-32B layer and its lm_head), fused attention,
   paged decode and ring decode (32 head-folds, G 5, kv8 and packed kv4,
   rings of 1024 and 8192 slots, partly written, wrapped and windowed)
   with codes exact and outputs within a stated tolerance;
4. serve: ``repro_torch.launch.serve.serve`` at Qwen2.5-32B widths
   (4 of 64 layers, random weights from a seed, made on the card) on the
   ``cuda`` backend; every request DONE, a clean audit, every kernel of
   the paged path launched and no plain-path dispatch; first-step logits
   against the ``torch`` backend on the same inputs; greedy agreement
   printed;
5. ring: ``lm.prefill`` + 16 ``lm.decode_step``s over the ring cache at
   the same widths, batch 4, 64-token prompts, rings of 1024 and 8192
   slots, on the ``cuda`` backend: 4 ring-kernel launches per step and no
   plain decode dispatch; the ``torch`` backend teacher-forced step by
   step (the ``cuda`` run's token and a copy of its cache) within a
   stated tolerance; free-running greedy agreement printed;
6. quickstart: ``python -m repro_torch.examples.quickstart`` on the card;
7. time: each kernel with CUDA events beside its bound, its plain version
   and, where one PyTorch call computes the same function, that call.

Prints a ``{"kernels": [...]}`` JSON line, then the result line
``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_LAYERS = 4                      # of Qwen2.5-32B's 64, for the time limit
PEAK_INT8_OPS = 1979e12           # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
ATTN_RTOL = 1e-5                  # Sigma is an f32 sum in another order
# cuda vs torch backend, whole model, bf16 activations: Sigma's f32 sum
# order moves a bf16-rounded attention output by one ulp (2^-8) now and
# then, and such flips cascade through the layers' activation codes.
LOGITS_RTOL = 5e-2
RING_STEPS = 16
RING_MAX_LENS = (1024, 8192)
RING_PROMPT = 64


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes, ops):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# Inputs at main-path shapes
# ---------------------------------------------------------------------------

def qmatmul_inputs(g, m, n, k, packed):
    import torch
    from repro_torch.core.quant import pack_int4
    dev = "cuda"
    x = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-8, 8, (n, k), generator=g, device=dev,
                      dtype=torch.int8)
    if packed:
        w = pack_int4(w)
    scale = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4
    bias = torch.randn((n,), generator=g, device=dev) * 0.1
    rs = torch.rand((m,), generator=g, device=dev) * 0.05 + 0.01
    return x, w, scale, bias, rs


def fused_inputs(g):
    """B=4, Hkv=8, G=5, Sq=Sk=64, D=128 folded as dispatch folds them."""
    import torch
    from repro_torch.kernels import dispatch
    b, hkv, grp, s, d = 4, 8, 5, 64, 128
    h = b * hkv
    bq, bk = dispatch.attention_blocks(grp * s, s, d,
                                       chunk=dispatch.chunk_len(s, 128))
    nq = -(-(grp * s) // bq)
    mk = lambda *shape: torch.randint(-127, 128, shape, generator=g,
                                      device="cuda", dtype=torch.int8)
    q, k, v = mk(h, grp * s, d), mk(h, s, d), mk(h, s, d)
    sc = (torch.rand((h, nq), generator=g, device="cuda") + 0.5) * 1e-4
    vs = (torch.rand((h,), generator=g, device="cuda") + 0.5) * 1e-2
    return (q, k, v, sc, vs), dict(attn_bits=7, causal=True, bq=bq, bk=bk,
                                   sq_mod=s)


def paged_inputs(g, kv_bits):
    """B=4, Hkv=8, G=5, D=128, page 16, 5 pages a row, page-scaled, row 2
    inactive."""
    import torch
    from repro_torch.core.quant import pack_int4
    b, hkv, grp, d, ps, maxp = 4, 8, 5, 128, 16, 5
    num = b * maxp + 1                               # + trash page
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    mk = lambda *shape: torch.randint(lo, hi, shape, generator=g,
                                      device="cuda", dtype=torch.int8)
    kp, vp = mk(num, hkv, ps, d), mk(num, hkv, ps, d)
    if kv_bits == 4:
        kp, vp = pack_int4(kp), pack_int4(vp)
    q = torch.randint(-127, 128, (b, hkv, grp, d), generator=g,
                      device="cuda", dtype=torch.int8)
    perm = torch.randperm(b * maxp, generator=g, device="cuda")
    pt = perm.reshape(b, maxp).to(torch.int32).contiguous()
    pos = torch.tensor([79, 35, -1, 63], dtype=torch.int32, device="cuda")
    sc = (torch.rand((b,), generator=g, device="cuda") + 0.5) * 1e-2
    vs = torch.ones((b,), device="cuda")
    kps = (torch.rand((num,), generator=g, device="cuda") + 0.5) * 1e-2
    vps = (torch.rand((num,), generator=g, device="cuda") + 0.5) * 1e-2
    return (q, kp, vp, sc, vs, pt, pos), dict(
        k_page_scale=kps, v_page_scale=vps, attn_bits=7,
        packed=kv_bits == 4)


def ring_inputs(g, kv_bits, span, pos):
    """One ring decode step as dispatch folds it: B=4 x Hkv=8 head-folds,
    G=5, D=128; the ring written up to ``pos`` (slot p % span)."""
    import torch
    from repro_torch.core.quant import pack_int4
    h, grp, d = 32, 5, 128
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    mk = lambda *shape: torch.randint(lo, hi, shape, generator=g,
                                      device="cuda", dtype=torch.int8)
    k, v = mk(h, span, d), mk(h, span, d)
    if kv_bits == 4:
        k, v = pack_int4(k), pack_int4(v)
    q = torch.randint(-127, 128, (h, grp, d), generator=g, device="cuda",
                      dtype=torch.int8)
    slot = pos % span
    kpos = (pos - torch.remainder(slot - torch.arange(span, device="cuda"),
                                  span)).to(torch.int32)
    sc = (torch.rand((h,), generator=g, device="cuda") + 0.5) * 1e-3
    vs = (torch.rand((h,), generator=g, device="cuda") + 0.5) * 1e-2
    posd = torch.tensor([pos], dtype=torch.int32, device="cuda")
    return (q, k, v, sc, vs, kpos, posd)


def rel_err(a, b):
    import torch
    err = (a - b).abs().max().item()
    return err, err / max(b.abs().max().item(), 1e-30)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} sources in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line or "error" in line.lower():
                log(f"[build:{name}] {line.strip()}")


QMM_NK = [(5120, 5120), (1024, 5120), (27648, 5120), (5120, 27648),
          (152064, 5120)]


def phase_check(g):
    import torch
    from repro_torch.kernels import int_attention as ia
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.qmatmul import qmatmul
    errs = {}
    for m in (4, 256):
        bm, bn, _ = dispatch.qmatmul_blocks(m, 1, 1)
        for n, k in QMM_NK:
            for packed in (False, True):
                args = qmatmul_inputs(g, m, n, k, packed)
                got = qmatmul(*args, bm=bm, bn=bn, packed=packed)
                torch.cuda.synchronize()
                want = ref.qmatmul_ref(*args)
                eq = torch.equal(got, want)
                log(f"[check] qmatmul M={m} N={n} K={k} packed={packed}: "
                    f"{'exact' if eq else 'MISMATCH'}")
                if not eq:
                    raise AssertionError(
                        f"qmatmul differs: max abs "
                        f"{(got - want).abs().max().item()}")
                del args, got, want
    errs["qmatmul"] = 0.0

    args, kw = fused_inputs(g)
    out, codes = ia.int_attention_fused(*args, return_codes=True, **kw)
    torch.cuda.synchronize()
    want, wcodes = ia.int_attention_fused_plain(*args, return_codes=True,
                                                **kw)
    abs_e, rel_e = rel_err(out, want)
    log(f"[check] fused attention bq={kw['bq']} bk={kw['bk']}: codes "
        f"{'exact' if torch.equal(codes, wcodes) else 'MISMATCH'}, "
        f"out max abs {abs_e:.3e} rel {rel_e:.3e} (tol rel {ATTN_RTOL})")
    if not torch.equal(codes, wcodes) or rel_e > ATTN_RTOL:
        raise AssertionError("fused attention differs from its plain version")
    errs["int_attention_fused"] = abs_e

    worst = 0.0
    for kv_bits in (8, 4):
        args, kw = paged_inputs(g, kv_bits)
        out, codes = ia.int_paged_decode_attention(*args, return_codes=True,
                                                   **kw)
        torch.cuda.synchronize()
        q, kp, vp, sc, vs, pt, pos = args
        want, wcodes = ref.int_paged_decode_attention_ref(
            q, kp, vp, sc, vs, pt, pos, attn_bits=7, bk=kp.shape[2],
            k_page_scale=kw["k_page_scale"], v_page_scale=kw["v_page_scale"],
            return_codes=True)
        abs_e, rel_e = rel_err(out, want)
        same = torch.equal(codes, wcodes)
        log(f"[check] paged decode kv_bits={kv_bits}: codes "
            f"{'exact' if same else 'MISMATCH'}, out max abs {abs_e:.3e} "
            f"rel {rel_e:.3e} (tol rel {ATTN_RTOL}); inactive row max "
            f"{out[2].abs().max().item():.1e}")
        if not same or rel_e > ATTN_RTOL or out[2].abs().max().item() != 0:
            raise AssertionError("paged decode differs from its plain version")
        worst = max(worst, abs_e)
    errs["int_paged_decode_attention"] = worst

    worst = 0.0
    for kv_bits, span, pos, window in RING_CHECKS:
        args = ring_inputs(g, kv_bits, span, pos)
        kw = dict(attn_bits=7, window=window, packed=kv_bits == 4,
                  bk=dispatch.decode_blocks(span, 128), return_codes=True)
        out, codes = ia.int_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        want, wcodes = ia.int_decode_attention_plain(*args, **kw)
        abs_e, rel_e = rel_err(out, want)
        same = torch.equal(codes, wcodes)
        log(f"[check] ring decode kv_bits={kv_bits} span={span} pos={pos} "
            f"window={window} bk={kw['bk']}: codes "
            f"{'exact' if same else 'MISMATCH'}, out max abs {abs_e:.3e} "
            f"rel {rel_e:.3e} (tol rel {ATTN_RTOL})")
        if not same or rel_e > ATTN_RTOL:
            raise AssertionError("ring decode differs from its plain version")
        worst = max(worst, abs_e)
    errs["int_decode_attention"] = worst
    return errs


# (kv_bits, span, pos, window): partly written (pos < span), wrapped
# (pos > span) and windowed rings of 1024 slots (bk 1024) and 8192 slots
# (bk 4096, two blocks).
RING_CHECKS = [(8, 1024, 79, None), (4, 1024, 79, None),
               (8, 1024, 5000, None), (4, 1024, 5000, None),
               (8, 8192, 79, None), (4, 8192, 79, None),
               (8, 8192, 20000, None), (4, 8192, 20000, None),
               (8, 8192, 9000, 3000), (4, 1024, 3000, 200)]


def model_config(backend):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import QuantConfig
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int",
                     backend=backend)
    return get_config("qwen2.5-32b").replace(n_layers=N_LAYERS, quant=qc)


def phase_serve():
    import torch
    from repro_torch.core.api import integerize_params
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve, staggered_prompts
    from repro_torch.models import lm
    cfg = model_config("cuda")
    log(f"[serve] Qwen2.5-32B widths, n_layers cut 64 -> {cfg.n_layers}; "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.kv_heads}, "
        f"head dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}")
    t0 = time.perf_counter()
    params = lm.init_params(cfg.replace(quant=None), seed=0, device="cuda")
    params = integerize_params(params, cfg.quant)
    torch.cuda.synchronize()
    log(f"[serve] random weights on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = staggered_prompts(8, 64, cfg.vocab)
    # 8 requests on 4 rows: with the reference's starvation threshold (8
    # steps < 16 generated tokens) equal-priority requests preempt each
    # other until some are rejected; above it, every request is served.
    kw = dict(gen_tokens=16, page_size=16, batch_size=4, audit_every=1,
              preempt_after_steps=32)

    serve(cfg, params, prompts[:4], **{**kw, "gen_tokens": 2})   # warm-up
    dispatch.reset_stats()
    dispatch.reset_launches()
    torch.cuda.synchronize()
    gen, stats = serve(cfg, params, prompts, **kw)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    snap = stats["dispatch"]
    statuses = [s["status"] for s in stats["per_seq"]]
    steps = max(stats["engine_steps"], 1)
    log(f"[serve] {len(prompts)} requests, batch 4: statuses {statuses}; "
        f"{stats['tok_per_s']:.1f} tok/s, {stats['engine_steps']} engine "
        f"steps, {stats['total_s'] / steps * 1e3:.2f} ms per engine step "
        f"(prefill included), total {stats['total_s']:.2f}s")
    log(f"[serve] launches {launches}; dispatch "
        f"{ {k: v for k, v in snap.items() if not isinstance(v, dict)} }")
    if any(s != "done" for s in statuses):
        raise AssertionError(f"not every request is DONE: {statuses}")
    if stats["audit_violations"] or stats["failures"]["audit_failures"]:
        raise AssertionError(f"audit: {stats['audit_violations']}")
    serve_kernels = ("qmatmul", "int_attention_fused",
                     "int_paged_decode_attention")
    if min(launches[k] for k in serve_kernels) <= 0:
        raise AssertionError(f"a kernel of the paged path never launched: "
                             f"{launches}")
    plain = {k: snap[k] for k in ("qlinear_torch", "attention_torch",
                                  "attention_paged_torch")}
    if any(plain.values()):
        raise AssertionError(f"plain-path dispatches on the cuda run: {plain}")

    # The torch backend on the same inputs: first-step logits and tokens.
    tcfg = model_config("torch")
    logits = {}
    for name, c in (("cuda", cfg), ("torch", tcfg)):
        cache = lm.init_paged_cache(c, 4, 80, page_size=16, device="cuda")
        cache["page_table"].copy_(torch.arange(4 * 5, dtype=torch.int32,
                                               device="cuda").reshape(4, 5))
        lens = [len(p) for p in prompts[:4]]
        toks = torch.zeros((4, max(lens)), dtype=torch.int32, device="cuda")
        for i, p in enumerate(prompts[:4]):
            toks[i, :len(p)] = torch.as_tensor(p, device="cuda")
        lg, cache = lm.paged_prefill(
            params, {"tokens": toks, "lengths": torch.tensor(
                lens, dtype=torch.int32, device="cuda")}, c, cache)
        nxt = torch.argmax(lg[:, 0], dim=-1).to(torch.int32)[:, None]
        lg2, _ = lm.decode_step(params, nxt, cache, c)
        logits[name] = (lg.float(), lg2.float(), nxt)
    for i, what in enumerate(("prefill", "first decode step")):
        abs_e, rel_e = rel_err(logits["cuda"][i], logits["torch"][i])
        log(f"[serve] {what} logits cuda vs torch backend: max abs "
            f"{abs_e:.3e} rel {rel_e:.3e} (tol rel {LOGITS_RTOL})")
        if rel_e > LOGITS_RTOL:
            raise AssertionError(f"{what} logits: cuda and torch differ")
    tgen, _ = serve(tcfg, params, prompts, **kw)
    agree = int((tgen == gen).sum())
    log(f"[serve] greedy tokens equal between backends: {agree}/{gen.size}")
    return stats, launches, params


def phase_ring(params):
    """Ring-cache generation at Qwen2.5-32B widths on the cuda backend, the
    torch backend teacher-forced beside it."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    cfg, tcfg = model_config("cuda"), model_config("torch")
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, RING_PROMPT), generator=g,
                         device="cuda", dtype=torch.int32)
    worst = {"prefill": 0.0, "forced": 0.0}
    free, step_ms = {}, {}
    dispatch.reset_stats()
    dispatch.reset_launches()
    torch.cuda.synchronize()
    for max_len in RING_MAX_LENS:
        t0 = time.perf_counter()
        lc, cache = lm.prefill(params, {"tokens": toks}, cfg, max_len=max_len)
        lt, _ = lm.prefill(params, {"tokens": toks}, tcfg, max_len=max_len)
        worst["prefill"] = max(worst["prefill"],
                               rel_err(lt.float(), lc.float())[1])
        fed, step_s = [], 0.0
        for _ in range(RING_STEPS):
            tok = torch.argmax(lc[:, 0], -1).to(torch.int32)[:, None]
            fed.append(tok)
            forced = clone_tree(cache)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lc, cache = lm.decode_step(params, tok, cache, cfg)
            torch.cuda.synchronize()
            step_s += time.perf_counter() - t1
            # teacher-forced: the cuda run's token and (a copy of) its cache
            lf, _ = lm.decode_step(params, tok, forced, tcfg)
            worst["forced"] = max(worst["forced"],
                                  rel_err(lf.float(), lc.float())[1])
            del forced
        torch.cuda.synchronize()
        step_ms[max_len] = step_s / RING_STEPS * 1e3
        log(f"[ring] max_len {max_len}: prefill + {RING_STEPS} decode steps "
            f"in {time.perf_counter() - t0:.2f}s (both backends); cuda "
            f"decode step {step_ms[max_len]:.2f} ms "
            f"({4e3 / step_ms[max_len]:.1f} tok/s at batch 4), pos "
            f"{int(cache['pos'])}")
        cuda_toks = torch.cat(fed, dim=1)
        lt, tcache = lm.prefill(params, {"tokens": toks}, tcfg,
                                max_len=max_len)
        own = []
        for _ in range(RING_STEPS):
            tok = torch.argmax(lt[:, 0], -1).to(torch.int32)[:, None]
            own.append(tok)
            lt, tcache = lm.decode_step(params, tok, tcache, tcfg)
        free[max_len] = int((torch.cat(own, dim=1) == cuda_toks).sum())
        del cache, tcache
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    snap = dispatch.snapshot()
    n_steps = RING_STEPS * len(RING_MAX_LENS)
    log(f"[ring] Qwen2.5-32B widths, {cfg.n_layers} layers, batch 4, "
        f"{RING_PROMPT}-token prompts, rings {RING_MAX_LENS}: launches "
        f"{launches}; decode dispatch cuda "
        f"{snap['attention_decode_cuda']} torch "
        f"{snap['attention_decode_torch']} (torch-backend steps included)")
    for what, err in worst.items():
        log(f"[ring] {what} logits, torch vs cuda backend: max rel "
            f"{err:.3e} over every step (tol rel {LOGITS_RTOL})")
    for max_len, n in free.items():
        log(f"[ring] free-running greedy tokens equal between backends, "
            f"ring {max_len}: {n}/{4 * RING_STEPS} (printed only)")
    if launches["int_decode_attention"] != cfg.n_layers * n_steps:
        raise AssertionError(f"ring kernel launches "
                             f"{launches['int_decode_attention']}, expected "
                             f"{cfg.n_layers} per decode step")
    if launches["qmatmul"] <= 0 or launches["int_attention_fused"] <= 0:
        raise AssertionError(f"a kernel of the ring path never launched: "
                             f"{launches}")
    # the cuda run's decode steps all went to the kernel; the torch-backend
    # steps beside them are the only plain decode dispatches
    if snap["attention_decode_cuda"] != cfg.n_layers * n_steps or \
            snap["attention_decode_torch"] != 2 * cfg.n_layers * n_steps:
        raise AssertionError(f"ring decode dispatch: {snap}")
    if worst["prefill"] > LOGITS_RTOL or worst["forced"] > LOGITS_RTOL:
        raise AssertionError(f"ring logits: cuda and torch differ {worst}")
    profile_decode(params, cfg, toks, step_ms[RING_MAX_LENS[-1]])
    return launches


def profile_decode(params, cfg, toks, step_ms, steps=4):
    """Where a ring decode step's time goes: torch.profiler over a few
    steps (after the counted run), device kernel time by name.  The busy
    share divides it by ``step_ms``, the step time of the counted run
    with the profiler off (the profiler's own host cost would inflate the
    wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    lg, cache = lm.prefill(params, {"tokens": toks}, cfg,
                           max_len=RING_MAX_LENS[-1])
    tok = torch.argmax(lg[:, 0], -1).to(torch.int32)[:, None]
    lm.decode_step(params, tok, cache, cfg)                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lm.decode_step(params, tok, cache, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3 / steps
    busy = sum(by_name.values())
    if busy <= 0:
        log(f"[profile] ring decode step {wall:.2f} ms wall; device time "
            f"not measured (the profiler saw no kernel)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] ring decode step (ring {RING_MAX_LENS[-1]}): device "
        f"busy {busy:.3f} ms of {step_ms:.2f} ms unprofiled "
        f"({100 * busy / step_ms:.1f}%; {wall:.2f} ms wall with the "
        f"profiler on); per step: "
        + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))


def clone_tree(tree):
    return {k: (clone_tree(v) if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


def phase_quickstart():
    import torch
    from repro_torch.examples import quickstart
    out = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    ran = {k: out["launches"][k] for k in
           ("qmatmul", "int_attention_fused", "int_decode_attention")}
    log(f"[quickstart] launches {ran}")
    if out["eq_err"] > 1e-5 or out["corr"] < 0.95 or min(ran.values()) <= 0 \
            or out["kv_dtype"] != "torch.int8":
        raise AssertionError(f"quickstart on the card: {out}")


def phase_time(g, launches, errs, stats):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import int_attention as ia
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.qmatmul import qmatmul
    rows = {}
    for m in (4, 256):
        bm, bn, _ = dispatch.qmatmul_blocks(m, 1, 1)
        for n, k in QMM_NK:
            for packed in (False, True):
                x, w, s, b, rs = qmatmul_inputs(g, m, n, k, packed)
                ms = cuda_ms(lambda: qmatmul(x, w, s, b, rs, bm=bm, bn=bn,
                                             packed=packed))
                pms = cuda_ms(lambda: ref.qmatmul_ref(x, w, s, b, rs),
                              iters=3, warmup=1)
                lib = None
                if m > 16 and not packed:
                    lib = cuda_ms(lambda: torch._int_mm(x, w.t()))
                nbytes = x.numel() + w.numel() + 8 * n + 4 * m + 4 * m * n
                bnd, by = bound_ms(nbytes, 2 * m * n * k)
                log(f"[time] qmatmul M={m} N={n} K={k} packed={packed}: "
                    f"{ms:.4f} ms, bound {bnd:.4f} ms ({by}), plain "
                    f"{pms:.4f} ms, _int_mm "
                    f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
                rows[(m, n, k, packed)] = (ms, pms, lib, bnd, by)
                del x, w, s, b, rs
    head = rows[(256, 27648, 5120, False)]
    kernels = [{"name": "qmatmul", "route": "cuda",
                "source": "src/repro_torch/csrc/qmatmul.cu",
                "replaces": "src/repro/kernels/qmatmul.py:119",
                "launches": launches["qmatmul"],
                "max_abs_err": errs["qmatmul"], "ms": head[0],
                "plain_ms": head[1], "bound_ms": head[3],
                "bound_by": head[4], "library_ms": head[2]}]

    args, kw = fused_inputs(g)
    q, k, v, sc, vs = args
    ms = cuda_ms(lambda: ia.int_attention_fused(*args, **kw))
    pms = cuda_ms(lambda: ia.int_attention_fused_plain(*args, **kw),
                  iters=3, warmup=1)
    h, sq, d = q.shape
    s = k.shape[1]
    grp = sq // s
    qb = torch.randn((4, 40, s, d), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    kb = torch.randn((4, 8, s, d), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, kb, is_causal=True, enable_gqa=True))
    nbytes = q.numel() + k.numel() + v.numel() + 4 * sc.numel() + \
        4 * vs.numel() + 4 * h * sq * d
    ops = 4 * d * h * grp * s * (s + 1) // 2
    bnd, by = bound_ms(nbytes, ops)
    log(f"[time] fused attention H={h} Sq={sq} Sk={s} D={d}: {ms:.4f} ms, "
        f"bound {bnd:.4f} ms ({by}), plain {pms:.4f} ms, bf16 SDPA "
        f"{lib:.4f} ms")
    kernels.append({"name": "int_attention_fused", "route": "cuda",
                    "source": "src/repro_torch/csrc/int_attention.cu",
                    "replaces": "src/repro/kernels/int_attention.py:569",
                    "launches": launches["int_attention_fused"],
                    "max_abs_err": errs["int_attention_fused"], "ms": ms,
                    "plain_ms": pms, "bound_ms": bnd, "bound_by": by,
                    "library_ms": lib})

    paged = {}
    for kv_bits in (8, 4):
        args, kw = paged_inputs(g, kv_bits)
        q, kp, vp, sc, vs, pt, pos = args
        ms = cuda_ms(lambda: ia.int_paged_decode_attention(*args, **kw))
        pms = cuda_ms(lambda: ref.int_paged_decode_attention_ref(
            q, kp, vp, sc, vs, pt, pos, attn_bits=7, bk=kp.shape[2],
            k_page_scale=kw["k_page_scale"],
            v_page_scale=kw["v_page_scale"]), iters=3, warmup=1)
        b, hkv, grp, d = q.shape
        ps, dk = kp.shape[2], kp.shape[3]
        live = [int(p) + 1 for p in pos.tolist() if p >= 0]     # keys
        pages = sum(-(-n // ps) for n in live)
        nbytes = hkv * pages * ps * dk * 2 + q.numel() + 4 * q.numel() + \
            4 * (2 * b + 2 * pages) + 4 * pt.numel() + 4 * b
        ops = 4 * d * grp * hkv * sum(live)
        bnd, by = bound_ms(nbytes, ops)
        lib = paged_sdpa_ms(g, q, pt, pos, ps)
        log(f"[time] paged decode kv_bits={kv_bits} B={b} live keys {live}: "
            f"{ms:.4f} ms, bound {bnd:.4f} ms ({by}), plain {pms:.4f} ms, "
            f"bf16 SDPA over the gathered pages, masked {lib:.4f} ms")
        paged[kv_bits] = (ms, pms, bnd, by, lib)
    ms, pms, bnd, by, lib = paged[8]
    kernels.append({"name": "int_paged_decode_attention", "route": "cuda",
                    "source": "src/repro_torch/csrc/int_attention.cu",
                    "replaces": "src/repro/kernels/int_attention.py:752",
                    "launches": launches["int_paged_decode_attention"],
                    "max_abs_err": errs["int_paged_decode_attention"],
                    "ms": ms, "plain_ms": pms, "bound_ms": bnd,
                    "bound_by": by, "library_ms": lib})

    ring = {}
    for kv_bits, span, pos in RING_TIMES:
        args = ring_inputs(g, kv_bits, span, pos)
        q, k, v, sc, vs, kpos, posd = args
        kw = dict(attn_bits=7, packed=kv_bits == 4,
                  bk=dispatch.decode_blocks(span, 128))
        ms = cuda_ms(lambda: ia.int_decode_attention(*args, **kw))
        pms = cuda_ms(lambda: ia.int_decode_attention_plain(*args, **kw),
                      iters=3, warmup=1)
        h, grp, d = q.shape
        dk = k.shape[2]
        live = (kpos >= 0) & (kpos <= pos)
        n_live = int(live.sum())
        bk = kw["bk"]
        live_blocks = int(live.reshape(-1, bk).any(dim=1).sum()) \
            if span % bk == 0 else -(-span // bk)
        # least bytes: q, the slot map, pos, scales, live K/V rows, out
        nbytes = q.numel() + 4 * span + 4 + 8 * h + 2 * h * n_live * dk + \
            4 * h * grp * d
        ops = 4 * d * grp * h * n_live
        bnd, by = bound_ms(nbytes, ops)
        blk_bnd, _ = bound_ms(nbytes + 2 * h * (live_blocks * bk - n_live)
                              * dk, ops)
        lib = ring_sdpa_ms(g, span, live)
        log(f"[time] ring decode kv_bits={kv_bits} H={h} G={grp} D={d} "
            f"span={span} bk={bk} pos={pos} (live keys {n_live}, live blocks "
            f"{live_blocks}): {ms:.4f} ms, bound {bnd:.4f} ms ({by}; "
            f"{blk_bnd:.4f} ms over the whole live blocks), plain "
            f"{pms:.4f} ms, bf16 SDPA over the live keys {lib:.4f} ms")
        ring[(kv_bits, span, pos)] = (ms, pms, bnd, by, lib)
    ms, pms, bnd, by, lib = ring[RING_TIMES[0]]
    kernels.append({"name": "int_decode_attention", "route": "cuda",
                    "source": "src/repro_torch/csrc/int_attention.cu",
                    "replaces": "src/repro/kernels/int_attention.py:649",
                    "launches": launches["int_decode_attention"],
                    "max_abs_err": errs["int_decode_attention"], "ms": ms,
                    "plain_ms": pms, "bound_ms": bnd, "bound_by": by,
                    "library_ms": lib})
    return kernels


# (kv_bits, span, pos): the ring phase's shapes (64-token prompts, so the
# last decode step reads positions 0..79) first, then full rings.
RING_TIMES = [(8, 1024, 79), (4, 1024, 79), (8, 8192, 79),
              (8, 4096, 4095), (8, 8192, 8191), (4, 8192, 8191)]


def ring_sdpa_ms(g, span, live):
    """Yardstick the port never calls: one bf16 SDPA over the ring's live
    keys, dequantized and gathered (B=4, 40 query heads on 8 kv heads)."""
    import torch
    import torch.nn.functional as F
    n = int(live.sum())
    qb = torch.randn((4, 40, 1, 128), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    kb = torch.randn((4, 8, n, 128), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    vb = torch.randn((4, 8, n, 128), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, enable_gqa=True))


def paged_sdpa_ms(g, q, pt, pos, ps):
    """Yardstick the port never calls: one bf16 SDPA per decode step over
    every row's pages gathered into a dense (B, Hkv, max_pages * ps, D)
    cache, masked to each row's positions."""
    import torch
    import torch.nn.functional as F
    b, hkv, grp, d = q.shape
    total = pt.shape[1] * ps
    qb = torch.randn((b, hkv * grp, 1, d), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    kb = torch.randn((b, hkv, total, d), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    vb = torch.randn((b, hkv, total, d), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    mask = (torch.arange(total, device="cuda")[None, :] <=
            pos.clamp(min=0)[:, None])[:, None, None, :]
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, enable_gqa=True))


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py needs the repository around it "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        log(f"[device] {card} | torch: {kind} x{count} | torch "
            f"{torch.__version__} CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_build()
        g = torch.Generator(device="cuda").manual_seed(0)
        errs = phase_check(g)
        stats, launches, params = phase_serve()
        ring_launches = phase_ring(params)
        launches["int_decode_attention"] = \
            ring_launches["int_decode_attention"]
        del params
        torch.cuda.empty_cache()
        phase_quickstart()
        kernels = phase_time(g, launches, errs, stats)
    except Exception:                 # report the failing phase, exit non-0
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
