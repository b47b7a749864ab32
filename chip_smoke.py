"""Run the PyTorch port's main path on one NVIDIA GPU and hold every CUDA
kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit (``nvidia-smi``), the device
   name and count seen by torch;
2. build: every ``src/repro_torch/csrc/*.cu`` with ``nvcc`` (all started at
   once), printing each kernel's registers and spills (``-Xptxas -v``);
3. check: each kernel against its plain version on the card at main-path
   shapes — qmatmul exactly, each row with its plan (the stream body at
   M = 4 and the tensor-core body at M = 256 at every (N, K) of one
   Qwen2.5-32B layer and its lm_head, three of them splitting K; the
   stream body also at M 1, 8, 9 and 16, the edges of its n8 tiles, at
   two of them; DeiT-S's four shapes, and M 17 and 129, N 300, K 1028;
   int8 and packed; the [archs] lm_heads N 202048, 92553 and 32064 at M 4
   and 256), the Llama-4-Scout expert product (16 experts, capacity 20,
   one launch an expert) bitwise against ``dense_expert``'s plain version,
   fused attention (also at the DeiT-S dispatch shape, bq 33, bk 224, and
   at G 7 and 6), paged decode (the serve shape, and G 16 at D 256; the
   [archs] head groups (Hkv, G) (2, 16), (8, 7), (10, 4), (8, 6); tables
   of 512 pages at 8192 tokens, kv8 and kv4, and G 16 at D 256 over a
   2048-token window; [serve-recurrent]'s decode, B 2 at Hkv 1, G 16, D
   256, 256-page tables, 2320 tokens, the 2048 window) and ring decode
   (32 head-folds, G 5, kv8 and packed kv4, rings of 1024 and 8192 slots,
   partly written, wrapped and windowed; G 16 at D 128 and 256, D 12)
   with codes exact and outputs within a stated tolerance; the attention
   kernels also at the paper's 2-, 3- and 4-bit prob grids (both prefill
   kernels at every prefill shape, the paged kernel at the serve shape,
   kv8 and kv4, the ring kernel at the ring phase's shape); PQ-LayerNorm
   codes exactly at the DeiT-S block, the reference's benchmark shape and
   Qwen2.5-32B's width, and at ragged widths (100 f32, 77 bf16), x one
   element into its buffer, without beta, 4 rows of 5120, and the first
   widths above the kernel's register plan;
   two-pass attention codes exact, outputs within the tolerance of its
   plain version and of the fused kernel at the same bq / bk; the
   [recurrent] / [encdec] shapes: qmatmul at the lm_heads N 256000 (K
   4096) and N 51866 (K 1280) and Mamba's in_proj N 3352 (K 768), the fused
   kernel at RecurrentGemma's windowed D 256 prefill and Whisper's encoder,
   self, cross and one-row decode cross attention, the ring kernel at a
   2176-slot windowed ring (G 16, D 256) and a 64-slot one (G 1, D 64);
   [dist]'s shapes on one of 4 ranks: qmatmul at N 5120 over K 1280 and
   6912 (Qwen2.5-32B's wo and down, a quarter of K each) at M 4 and 256,
   and Llama-4-Scout's 4 local experts over 80 slots; qmatmul's int32
   accumulator output exactly at [tp]'s row-parallel products (N 5120 over
   K 5120, 27648 and 8192, and a quarter of each), M 4 and 256, int8 and
   packed; [dryrun] (b)'s shapes: Qwen2.5-32B's qmatmul at M 8 over rank
   0's N 5120, 1024, 1728 and 9504 (K 5120), its int32 sums at N 5120 over
   K 5120 and the K slice 1728, the ring kernel at 64 head-folds over a
   whole 32768-slot ring; RecurrentGemma-9B's qmatmul at M 1 over N 4096,
   256, 768 and 16000 (K 4096), its int32 sums at N 4096 over K 4096, 256
   and 768, the ring kernel at one head-fold over its 2176-slot local ring
   after 524287 tokens (these rows timed too);
4. serve: ``repro_torch.launch.serve.serve`` at Qwen2.5-32B widths
   (4 of 64 layers, random weights from a seed, made on the card) on the
   ``cuda`` backend; every request DONE, a clean audit, every kernel of
   the paged path launched and no plain-path dispatch; first-step logits
   against the ``torch`` backend on the same inputs (each backend's
   route gated: the ``torch`` run launches no kernel, the ``cuda`` run
   every kernel of the path and no plain dispatch), the same at 2 of the
   4 layers, and the prefill layer by layer, teacher-forced; greedy
   agreement printed;
5. ring: ``lm.prefill`` + 16 ``lm.decode_step``s over the ring cache at
   the same widths, batch 4, 64-token prompts, rings of 1024 and 8192
   slots, on the ``cuda`` backend: one ring-kernel launch per layer and
   step and no plain decode dispatch; the ``torch`` backend
   teacher-forced step by step (the ``cuda`` run's token and a copy of its
   cache) within a stated tolerance; free-running greedy agreement
   printed;
6. faults: the paged engine (``launch/engine.py``) at the same widths,
   six staggered requests on 4 rows over a pool that holds four, audited
   after every step, against a fault-free run of the same script: drill 1
   (a page steal that forces a victim, two stalls under the watchdog, a
   NaN row) bitwise equal to it with every recovery counted and no plain
   dispatch; drill 2 (two forced fallback steps) runs exactly two decode
   steps on the plain path, token agreement printed;
7. archs: ChatGLM3-6B, Yi-34B, Phi-3-medium, InternVL2-26B, Llama-4-Scout
   and Phi-3.5-MoE at their published widths with 2 layers (random
   weights from a seed, made on the card, the float tree freed after
   integerization), each through ``serve`` (4 staggered requests of up to
   64 tokens, 8 generated, pages of 16) on the ``cuda`` backend: every
   request DONE, a clean audit, every kernel of the paged path launched
   (and the expert product for MoE), no plain dispatch; first-step logits
   against the ``torch`` backend within the stated tolerance (for MoE, a
   miss is allowed only where a route flip explains it: the prefill layer
   by layer, teacher-forced, then gates); InternVL2 also on the ring path
   with its 256 patch embeddings, gated like ``ring``;
8. recurrent: RecurrentGemma-9B at its published widths with n_layers cut
   from 38 to 5 (one (rglru, rglru, local) unit and the two remainder
   rglru layers), batch 2, 2304-token prompts past the 2048 window into a
   4096 ring (a 2176-slot local ring that wraps at prefill); the Mamba
   example (``repro_torch.examples.serve_mamba130m``) at its defaults;
   Mamba2-130M at full size, batch 4, 512-token prompts (four SSD chunks);
9. serve-recurrent: the same RecurrentGemma-9B and Mamba2-130M through
   the paged engine (``launch/engine.py``, one row a prompt, pages of 16,
   audited every step, 16 greedy tokens, 4 decode steps profiled):
   RecurrentGemma at max_len 4096 with (a) two 2304-token prompts filling
   their bucket, (b) prompts of 2304 and 1800 in it, (c) (a) prefilled in
   chunks of 1024; Mamba with four 512-token prompts.  Gates, each run:
   every request DONE with a clean audit, its ``[route]`` (qmatmul, and
   the fused and paged kernels for RecurrentGemma; no plain dispatch),
   the engine's first step on the ``cuda`` and ``torch`` backends within
   the stated tolerance; in (a) the first-step logits within it of the
   ring prefill's, the ring's tokens printed; Mamba's tokens equal to its
   ring generation's; ms per engine step, tok/s and peak memory printed;
10. encdec: Whisper-large-v3 at its published widths, 4 + 4 of 32 + 32
   layers, batch 4, 1500 seeded stub frames, 32-token prompts, max_len
   64; each run of 8 and 10 generates 16 greedy tokens on the ``cuda``
   backend with the ``torch`` backend teacher-forced beside it: its kernels
   launched (the ring kernel once a local layer a step), no plain dispatch,
   the ``torch`` run launching nothing, logits within the tolerance, its
   peak memory, time and a profiled decode step printed;
11. dist: the distributed layer (``repro_torch.distributed``) on NCCL,
   one rank a card (``torch.cuda.device_count()`` ranks, spawned; one in a
   one-card run), on a (data 1, model n) mesh under
   ``Rules(batch=("data",), int_bf16_reduce=True, moe_a2a=True)``:
   Qwen2.5-32B widths at 2 layers, batch 4, 256-token prompts and 16 ring
   steps (every row-parallel linear through the shard body: 2 a layer a
   forward, qmatmul on the rank's K slice, an f32 reduce-scatter and a
   bf16 all-gather), gated like ``ring`` with the ``torch`` backend
   teacher-forced; Llama-4-Scout widths at 2 layers, the prefill's MoE FFNs
   through the all-to-all (the rank's experts on qmatmul), gated like
   ``archs``; layer 0's row-parallel linears and its a2a FFN alone, cuda
   against torch, bitwise at one rank and within one bf16 ulp past it;
   ``compress_psum`` over Qwen-width gradients and ``pipeline_forward``
   with stages = ranks, each equal to its plain arithmetic; times printed.
   Then [tp], partitioned serving on the same ranks (mesh (data 1, model
   n), ``Rules(batch=("data",), partitioned=True)``, each rank holding only
   its shard of the weights and ring caches): (a) Qwen2.5-32B and
   Llama-4-Scout widths at 2 layers from ``partition.build_params``,
   prefill of 4 x 256 tokens and 16 greedy ring steps, gated by [route]
   (every linear on qmatmul, every row-parallel product on its int32
   accumulator output, attention on the fused and ring kernels, no plain
   dispatch) and bitwise equal to rank 0's one-rank run of the same tree
   (logits every step, tokens, the gathered ring caches), then each again
   under the residual's sequence split (``Rules(seq_tp=("model",))``,
   Megatron-SP; the identity at one card): gated by [route], bitwise on
   every rank against the run without it (logits, tokens, cache shard),
   every kernel call at the shape it has without it (``KernelCalls``) and
   layer 0's bytes sent, what the split changes, equal to
   ``sp_wire_analytic``; (b) at four
   cards only, Llama-4-Scout at its 48 layers, each rank building its
   shard: its bytes and peak memory under the card's, the global tree's
   (meta shapes) above it, 16 ring steps on the cuda backend with the
   torch backend teacher-forced within the tolerance. Then
   [tp-families], the recurrent and encoder-decoder families served
   partitioned on the same ranks (RecurrentGemma-9B at 5 layers, batch 2,
   2304-token prompts, its RG-LRU split by d_rnn and its local attention
   whole; Mamba2-130M at full size, batch 4, 512-token prompts, the SSD
   mixer whole; Whisper-large-v3 at 4 + 4 layers, batch 4, 1500 stub
   frames, 32-token prompts, attention and caches split by head), each
   from ``partition.build_params``, prefill and 16 greedy ring steps on
   (data 1, model n) and, at four cards, on (data 2, model 2) too
   (RecurrentGemma at batch 4, Mamba and Whisper at 8); gated by [route]
   and bitwise equal to rank 0's one-rank run (logits every step, tokens,
   the gathered caches with their states), RecurrentGemma also under the
   sequence split, gated as [tp]'s; first, cuBLAS's decode-row
   gate product against a rank's slices, and ``rglru.gate_step``'s, and
   torch's row mean against a few of its rows, and the norms'. Then [tp-train],
   partitioned training on the same ranks (``Rules(batch=("data",),
   partitioned=True, expert_fsdp=True)``, ZeRO-1 moments; fake
   w4/a8/attn7, bf16, 3 LAMB steps on 4 x 256 tokens): (a) Qwen2.5-32B at
   2 layers and Llama-4-Scout at 1, full width, on (data 1, model 1) and,
   at four cards, (data 2, model 2), against rank 0's one-rank run
   (bitwise on one rank; past it loss, grad norm and params within stated
   bounds) with the whole leaves' gradients bitwise on every rank; (b) at
   four cards, Llama-4-Scout at 4 layers on (data 1, model 4); each
   trained tree integerized on its ranks and served 8 ring steps, gated by
   [route];
11b. dryrun: the production-mesh dry run (``repro_torch.launch.dryrun``):
   (a) rank 0 of the 16 x 16 mesh on meta tensors under torch's fake
   process group, one process each on the CPU, for Qwen2.5-32B decode_32k
   and train_4k, Llama-4-Scout train_4k (experts split over "data") and
   under "opt", RecurrentGemma-9B and Mamba2-130M long_500k and
   Whisper-large-v3 prefill_32k, and Qwen2.5-32B train_4k under "sp" (the
   residual's sequence split: its arguments gated equal to the baseline
   cell's, its temp printed beside the baseline's), each gated at status
   "ok", with its rank's argument bytes, FLOPs and collective bytes
   printed; (b)
   meanwhile, in a process of its own, rank 0 of Qwen2.5-32B decode_32k
   (all 64 layers) and RecurrentGemma-9B long_500k really run on the card
   under the fake group on a CUDA mesh: its tree from
   ``partition.build_params(layout=rank 0)``, the ring as after all but
   one of its positions, the ``cuda`` backend; gated: argument bytes equal
   to the dry run's, bytes sent and collective result bytes equal, every
   plain dispatch the dry run counted a kernel dispatch on the card, each
   kernel call a launch (qmatmul, qmatmul_acc, the ring kernel), each at a
   shape the check phase held to its plain version; the measured peak
   (``max_memory_allocated``) printed beside the forecast, the rank's
   arguments (a serving cell's temp is not forecast); the phase's time
   printed;
12. quickstart: ``python -m repro_torch.examples.quickstart`` on the card;
13. vit: ``models.vit.forward`` at the full DeiT-S config (12 layers,
   224 px, patch 16; random weights from a seed, made on the card), batch
   64, on the ``cuda`` backend: 73 qmatmul and 12 fused-attention launches
   and no plain dispatch; logits against the ``torch`` backend; ms per
   batch;
14. ops: the paper's integerized self-attention module through the kernel
   entry points (``kernels/ops.py``) at DeiT-S widths, on layer 0 of the
   same weights and the model's own residual stream (64 x 198 rows):
   PQ-LayerNorm -> q/k/v -> fused and two-pass attention -> wo, every
   kernel against its plain version on the same inputs;
15. lowbit: DeiT-S at the paper's 3- and 2-bit points (w3/attn3,
    w2/attn2; Table II) on the ``cuda`` backend, gated like ``vit``; then
    ``benchmarks/fig_softmax_error.py``'s attention through
    ``layers.attention.attention`` at prob grids of 2, 3, 4 and 7 bits,
    each through the fused kernel, its error not growing with bits;
16. train: the paper's QAT recipe (``repro_torch.launch.train``,
    ``examples/train_cifar_qat.py``'s step) at DeiT-S's full size, batch
    64, fake w4/a8/attn7, LAMB: 10 head-only and 50 full steps (every loss
    finite, the head-only step leaving every other leaf bitwise, the last
    5 losses below the first 5), then ``integerize_params`` and the int
    forward on a held-out batch through the ``[route]`` gate (73 qmatmul,
    12 fused, no plain dispatch), accuracies printed; one full DeiT-S step
    at batch 8 on the card against the CPU (loss within 1e-4, gradient
    norm within 1e-3; past that, the step with the CPU's fake-quant values
    replayed within 1e-4, each layer teacher-forced within 5e-2, and the
    code flips counted layer by layer); ``make_train_step`` at
    Qwen2.5-32B's widths with 2 layers, bf16, batch 2 x 512 (two
    head-only steps, the freeze bitwise, two full steps); ``train()``
    restarted from its checkpoint bitwise equal to an uninterrupted run;
    ms per step, peak memory and a profiled step printed;
17. time: each kernel with CUDA events beside its bound, its plain
    version and, where one PyTorch call computes the same function, that
    call (``torch._int_mm`` for qmatmul and its accumulator output, over x
    zero-padded to 32 rows at decode rows, ``F.layer_norm`` /
    ``F.rms_norm`` for PQ-LayerNorm); every
    kernel also with its device time alone (``torch.profiler``), since
    CUDA events count the host's launch overhead at small shapes; a device
    time, and its share of the bound, is quoted only from traces that saw
    every kernel event (else "not measured").
    PQ-LayerNorm and its library call take x from copies cycled past the
    50 MB L2.  The expert product is timed at Llama-4-Scout's prefill and
    decode capacities (printed only: its launches are qmatmul's).

Prints a ``{"kernels": [...]}`` JSON line (``launches``: the counted
runs of each kernel's main paths, summed, and by path in
``launches_by_path``), then the result line ``{"ok": true, "device":
{...}}`` last.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_LAYERS = 4                      # of Qwen2.5-32B's 64, for the time limit
PEAK_INT8_OPS = 1979e12           # H100 SXM dense int8 tensor-core rate
PEAK_F32_OPS = 67e12              # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
L2_PAST = 64 * 10**6              # bytes of inputs cycled past the 50 MB L2
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


# torch.cuda._sleep's kernel, launched first in every trace: a trace can
# drop its first kernel event (seen on the H100 machine: one event of
# every trace, in every row of the time phase), and this one is left out
MARKER = "spin_kernel"


def device_trace(run, cpu=False):
    """torch.profiler over ``run()``, the marker kernel launched and
    synchronised first and left out: (the device events of
    ``key_averages()``, each device kernel's (start, end, name) in us;
    neither holds the device side of a ``record_function`` range, which
    would count its kernels twice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()

    def kernel(e, name):
        return e.device_type == torch.autograd.DeviceType.CUDA and \
            MARKER not in name and not getattr(e, "is_user_annotation", False)
    return ([e for e in prof.key_averages() if kernel(e, e.key)],
            [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if kernel(e, e.name)])


def device_events(run, cpu=False):
    """The device events (``key_averages()``) of ``run()``
    (:func:`device_trace`)."""
    return device_trace(run, cpu)[0]


def union_us(spans):
    """The time covered by the union of (start, end, ...) spans."""
    total, reach = 0.0, float("-inf")
    for start, end, *_ in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def device_ms(fn, calls=10):
    """Device time of one call of ``fn`` (torch.profiler, every kernel it
    launches), where ``cuda_ms`` also counts the host's launch overhead
    whenever the host enqueues more slowly than the card runs.  Two traces
    of one call give its number of kernel events (the larger count); two
    traces of ``calls`` calls each are kept only if each saw ``calls`` times
    that many (a trace that drops events reads short).  Returns (the larger kept read, or
    None when no trace was complete; the events the traces saw, as "one
    call / each trace of ``calls``")."""
    import torch

    def trace(n):
        evs = device_events(lambda: [fn() for _ in range(n)])
        return (sum(e.count for e in evs),
                sum(e.self_device_time_total for e in evs))

    fn()
    torch.cuda.synchronize()
    per_call = max(trace(1)[0] for _ in range(2))
    traces = [trace(calls) for _ in range(2)]
    kept = [us for n, us in traces if per_call and n == calls * per_call]
    seen = f"{per_call} / {' and '.join(str(n) for n, _ in traces)}"
    return (max(kept) / 1e3 / calls if kept else None), seen


def dev_str(dev, bnd=None):
    """A ``device_ms`` result as the time lines print it, with its share of
    the bound when given; a trace that missed kernel events quotes none."""
    dms, seen = dev
    if dms is None:
        return (f"device not measured: kernel events seen {seen} (one call "
                f"/ each trace)")
    share = f", {100 * bnd / dms:.1f}% of the bound" if bnd else ""
    return f"device {dms:.4f} ms{share}"


def bound_ms(nbytes, ops, peak=PEAK_INT8_OPS):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
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


def paged_inputs(g, kv_bits, grp=5, d=128, maxp=5, pos=(79, 35, -1, 63),
                 window=None, bits=7, hkv=8):
    """B=4, Hkv=8, G=5, D=128 (or a row per given position and the given
    Hkv, G, D), page 16, a table of 5 pages a row (or maxp) in a random
    permutation of the pool,
    page-scaled, at the given positions (row 2 inactive by default), window
    and prob grid bits."""
    import torch
    from repro_torch.core.quant import pack_int4
    b, ps = len(pos), 16
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
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    sc = (torch.rand((b,), generator=g, device="cuda") + 0.5) * 1e-2
    vs = torch.ones((b,), device="cuda")
    kps = (torch.rand((num,), generator=g, device="cuda") + 0.5) * 1e-2
    vps = (torch.rand((num,), generator=g, device="cuda") + 0.5) * 1e-2
    return (q, kp, vp, sc, vs, pt, pos), dict(
        k_page_scale=kps, v_page_scale=vps, attn_bits=bits, window=window,
        packed=kv_bits == 4)


def ring_inputs(g, kv_bits, span, pos, grp=5, d=128, h=32):
    """One ring decode step as dispatch folds it: B=4 x Hkv=8 head-folds,
    G=5, D=128 (or the given G, D and head-folds); the ring written up to
    ``pos`` (slot p % span)."""
    import torch
    from repro_torch.core.quant import pack_int4
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
            if "error" in line.lower():
                log(f"[build:{name}] {line.strip()}")
        for kernel, regs, spills in ptxas_summary(text):
            log(f"[build:{name}] {kernel}: {regs} registers, {spills}")


TYPE_ARGS = {"f": "float", "13__nv_bfloat16": "bf16"}   # mangled names


def ptxas_summary(text):
    """(kernel, registers, spills) for each entry function in an
    ``-Xptxas -v`` log; the kernel as name<template arguments>."""
    import re
    out, kernel, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            n = re.search(r"\d+([a-z_]+_kernel)(I.*?E(?=Ev))?", mangled)
            kernel = n.group(1) if n else mangled
            if n and n.group(2):            # template arguments, as mangled
                found = re.findall(r"13__nv_bfloat16|(?<=^I)f|L[ib]\d+E",
                                   n.group(2))
                args = [TYPE_ARGS.get(a, a[2:-1]) for a in found] or \
                    [n.group(2)[1:-1]]
                kernel += "<" + ",".join(args) + ">"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            spills = f"{m.group(1)} bytes spill stores, {m.group(2)} loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m.group(1)), spills))
            kernel, spills = None, ""
    return out


QMM_NK = [(5120, 5120), (1024, 5120), (27648, 5120), (5120, 27648),
          (152064, 5120)]
# the [archs] lm_heads whose N is not a multiple of 128: Llama-4-Scout,
# InternVL2-26B, Phi-3.5-MoE
QMM_HEADS = [(202048, 5120), (92553, 6144), (32064, 4096)]
# the [recurrent] / [encdec] shapes no other row covers: RecurrentGemma-9B's
# lm_head (N 256000, K 4096) at its 2 rows and at 256, Whisper-large-v3's
# (N 51866, K 1280) at 4 and 256, Mamba2-130M's in_proj (N 3352, K 768) at
# 4 rows and its prefill's 2048
QMM_FAMILIES = [(2, 256000, 4096), (256, 256000, 4096), (4, 51866, 1280),
                (256, 51866, 1280), (4, 3352, 768), (2048, 3352, 768)]
# [dist]'s row-parallel products on each of 4 ranks: Qwen2.5-32B's wo (K
# 5120 / 4) and MLP down (K 27648 / 4), N 5120, at decode and prefill rows
QMM_DIST = [(m, 5120, k) for m in (4, 256) for k in (1280, 6912)]
# [dryrun] (b)'s products on rank 0 of the 16 x 16 mesh: Qwen2.5-32B's
# decode_32k, its 8 rows through its sixteenth of wq's columns (N 320) and
# of wk's and wv's (N 64: attention by column), of the MLP's gate and up (N
# 1728) and of the lm_head (N 9504); RecurrentGemma-9B's long_500k, its one
# row through its sixteenth of wq (N 256, as of the RG-LRU's d_rnn), of wk
# and wv (N 16: a sixteenth of its one KV head), of the MLP's up (N 768)
# and of the lm_head (N 16000)
QMM_DRYRUN = [(8, 5120 // 16, 5120), (8, 1024 // 16, 5120),
              (8, 27648 // 16, 5120), (8, 152064 // 16, 5120),
              (1, 4096 // 16, 4096), (1, 256 // 16, 4096),
              (1, 12288 // 16, 4096), (1, 256000 // 16, 4096)]
# [dryrun] (b)'s row-parallel int32 sums (qmatmul_acc), N d_model, on the
# rank's K slice: Qwen2.5-32B's wo (K 320) and MLP down (K 1728);
# RecurrentGemma-9B's wo and RG-LRU w_out (both K 256) and MLP down (K 768)
QMM_DRYRUN_ACC = [(8, 5120, 5120 // 16, False),
                  (8, 5120, 27648 // 16, False),
                  (1, 4096, 4096 // 16, False),
                  (1, 4096, 12288 // 16, False)]
# qmatmul's accumulator output (int32 sums, no epilogue) at [tp]'s
# row-parallel products: Qwen2.5-32B's wo (K 5120) and down (K 27648) and
# Llama-4-Scout's shared-expert down (K 8192), whole at one rank and a
# quarter of K on each of 4, at decode and prefill rows, int8 and packed;
# then [dryrun] (b)'s
QMM_ACC = [(m, 5120, k, packed) for m in (4, 256)
           for k in (5120, 27648, 8192, 1280, 6912, 2048)
           for packed in (False, True)] + QMM_DRYRUN_ACC
# [tp-shard-bodies]' row-parallel products in the bf16 shard body: the
# rank's K slice on qmatmul with the scaled epilogue (f32(acc) * (w_scale
# * x_scale), no bias, no row scale), N d_model, at decode (4) and prefill
# (4 x 256) rows: Qwen2.5-32B's wo (K 5120) and down (27648),
# Llama-4-Scout's shared down (8192), Phi-3.5-MoE's wo (N and K 4096),
# whole on one card and a quarter on each of 4, int8 and packed
QMM_SHARD = [(m, n, k // w, packed) for m in (4, 1024)
             for n, k in ((5120, 5120), (5120, 27648), (5120, 8192),
                          (4096, 4096)) for w in (1, 4)
             for packed in (False, True)]
# DeiT-S's linears at batch 64: the patch embedding (64 x 196 rows, K 768),
# wq/wk/wv/wo, the MLP's up and down (64 x 198 rows)
QMM_DEIT = [(64 * 196, 384, 768), (64 * 198, 384, 384),
            (64 * 198, 1536, 384), (64 * 198, 384, 1536)]
# qmatmul checked at decode and prefill rows of every Qwen2.5-32B (N, K)
# (at 256 rows three of them split K), the decode body's n8-tile edges
# (M 1, 8, 9, 16) at the MLP down and wk/wv shapes, DeiT-S's shapes, and
# rows, columns and K off the tiles (K 1028 is padded to 16 or 32); int8
# and packed
QMM_CHECKS = [(m, n, k, packed) for m in (4, 256) for n, k in QMM_NK
              for packed in (False, True)] + \
    [(m, n, k, packed) for m in (1, 8, 9, 16)
     for n, k in ((5120, 27648), (1024, 5120)) for packed in (False, True)] + \
    [(m, n, k, packed) for m, n, k in QMM_DEIT + [(17, 300, 1028),
                                                  (129, 300, 1028)]
     for packed in (False, True)] + \
    [(m, n, k, False) for m in (4, 256) for n, k in QMM_HEADS] + \
    [(m, n, k, False) for m, n, k in QMM_FAMILIES + QMM_DIST + QMM_DRYRUN]


def phase_check(g):
    import torch
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.pq_layernorm import pq_layernorm
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_acc
    errs = {}
    worst = 0.0
    for m, n, k, packed in QMM_CHECKS:
        args = qmatmul_inputs(g, m, n, k, packed)
        blocks = dispatch.qmatmul_blocks(m, n, k)
        got = qmatmul(*args, blocks=blocks, packed=packed)
        torch.cuda.synchronize()
        want = ref.qmatmul_ref(*args)
        diff = (got - want).abs().max().item()
        log(f"[check] qmatmul M={m} N={n} K={k} packed={packed} plan "
            f"{blocks}: "
            f"{'exact' if diff == 0 else f'MISMATCH (max abs {diff})'}")
        if diff != 0:
            raise AssertionError("qmatmul differs from its plain version")
        if blocks[0] != ("stream" if m <= 16 else "mma"):
            raise AssertionError(f"qmatmul plan {blocks} at M={m}")
        worst = max(worst, diff)
        del args, got, want

    for m, n, k, packed in QMM_SHARD:
        x, w, sc, _, _ = qmatmul_inputs(g, m, n, k, packed)
        blocks = dispatch.qmatmul_blocks(m, n, k)
        got = qmatmul(x, w, sc, blocks=blocks, packed=packed)
        torch.cuda.synchronize()
        diff = (got - ref.qmatmul_ref(x, w, sc)).abs().max().item()
        log(f"[check] qmatmul shard body M={m} N={n} K={k} packed={packed} "
            f"(scaled epilogue, no bias) plan {blocks}: "
            f"{'exact' if diff == 0 else f'MISMATCH (max abs {diff})'}")
        if diff != 0:
            raise AssertionError("qmatmul differs from its plain version")
        del x, w, sc, got

    # Llama-4-Scout's prefill expert product, and the all-to-all body's on
    # one card (16 experts over 80 slots) and one of 4 ranks (its 4 local
    # experts over 4 sources' 20 slots); Phi-3.5-MoE's on one of 4 ranks
    # (4 experts over 4 x 40 slots, din 4096, dout 6400)
    errs["qmatmul"] = max(worst, check_expert(g), check_expert(g, 4, 80),
                          check_expert(g, 16, 80),
                          check_expert(g, 4, 160, 4096, 6400))

    worst = 0
    for m, n, k, packed in QMM_ACC:
        x, w, s, b, rs = qmatmul_inputs(g, m, n, k, packed)
        blocks = dispatch.qmatmul_blocks(m, n, k)
        got = qmatmul_acc(x, w, blocks=blocks, packed=packed)
        torch.cuda.synchronize()
        diff = int((got.long() - ref.qmatmul_acc_ref(x, w).long()).abs().max())
        log(f"[check] qmatmul_acc M={m} N={n} K={k} packed={packed} plan "
            f"{blocks}: int32 sums "
            f"{'exact' if diff == 0 else f'MISMATCH (max abs {diff})'}")
        if diff:
            raise AssertionError("qmatmul_acc differs from its plain version")
        worst = max(worst, diff)
        del x, w, s, b, rs, got
    errs["qmatmul_acc"] = float(worst)

    # the shapes dispatch gives the fused kernel on the main paths
    for name, q_chunk in (("qwen", 128), ("deit", 256), ("yi", 128),
                          ("internvl2", 128)):
        _, sq, sk, d, _, bq, bk, sq_mod = ATTN_CASES[name]
        blocks = dispatch.attention_blocks(
            sq, sk, d, chunk=dispatch.chunk_len(sq_mod or sq, q_chunk))
        if blocks != (bq, bk):
            raise AssertionError(f"attention case {name}: dispatch picks "
                                 f"{blocks}, the table ({bq}, {bk})")
    fused = two = 0.0
    for bits in (7,) + LOW_BITS:
        for name, case in ATTN_CASES.items():
            f_abs, t_abs = check_attention(g, name, case, bits)
            fused, two = max(fused, f_abs), max(two, t_abs)
    for name in ATTN_FAMILIES:
        fused = max(fused, check_family_attention(g, name))
    errs["int_attention_fused"], errs["int_attention"] = fused, two
    rows = [(row, 7, 8) for row in PAGED_CHECKS + PAGED_LONG] + \
        [(row, bits, 8) for bits in LOW_BITS for row in PAGED_CHECKS[:2]] + \
        [(row[:3], 7, row[3]) for row in PAGED_ARCHS] + \
        [(PAGED_SERVE_REC[0], 7, PAGED_SERVE_REC[1])]
    errs["int_paged_decode_attention"] = max(check_paged(g, row, bits, hkv)
                                             for row, bits, hkv in rows)
    rows = [(row, 7) for row in RING_CHECKS + RING_FAMILIES
            + RING_DRYRUN] + [(RING_CHECKS[0], bits) for bits in LOW_BITS]
    errs["int_decode_attention"] = max(check_ring(g, row, bits)
                                       for row, bits in rows)

    worst = 0
    for case in PQLN_CHECKS:
        args, kw = pqln_inputs(g, *case)
        got = pq_layernorm(*args, **kw)
        torch.cuda.synchronize()
        want = ref.pq_layernorm_ref(*args, **kw)
        diff = int((got.int() - want.int()).abs().max())
        log(f"[check] pq_layernorm rows={case[0]} d={case[1]} {case[2]} "
            f"bits={kw['bits']} rms_only={kw['rms_only']} beta={case[5]} "
            f"x offset {case[6]}: codes "
            f"{'exact' if diff == 0 else f'MISMATCH (max step {diff})'}")
        if diff:
            raise AssertionError("pq_layernorm differs from its plain version")
        worst = max(worst, diff)
    errs["pq_layernorm"] = float(worst)         # in code steps
    return errs


def check_attention(g, name, case, bits):
    """Both prefill kernels at one ``ATTN_CASES`` shape and prob grid:
    codes exact against the plain version, outputs within ATTN_RTOL; the
    max abs error of each."""
    import torch
    from repro_torch.kernels import int_attention as ia
    args, kw = attention_inputs(g, *case, bits=bits)
    one, fcodes = ia.int_attention_fused(*args, return_codes=True, **kw)
    out, codes = ia.int_attention(*args, return_codes=True, **kw)
    torch.cuda.synchronize()
    want, wcodes = ia.int_attention_plain(*args, return_codes=True, **kw)
    f_abs, f_rel = rel_err(one, want)
    t_abs, t_rel = rel_err(out, want)
    x_abs, x_rel = rel_err(out, one)
    same = torch.equal(fcodes, wcodes) and torch.equal(codes, wcodes)
    log(f"[check] attention {name} H={case[0]} Sq={case[1]} Sk={case[2]} "
        f"D={case[3]} causal={case[4]} bq={kw['bq']} bk={kw['bk']} "
        f"attn_bits={bits}: codes of both kernels "
        f"{'exact' if same else 'MISMATCH'}; against the plain version, "
        f"fused max abs {f_abs:.3e} rel {f_rel:.3e}, two-pass max abs "
        f"{t_abs:.3e} rel {t_rel:.3e}; two-pass against fused max abs "
        f"{x_abs:.3e} rel {x_rel:.3e} (tol rel {ATTN_RTOL})")
    if not same or max(f_rel, t_rel, x_rel) > ATTN_RTOL:
        raise AssertionError(f"attention {name} at {bits} bits: a kernel "
                             f"differs")
    return f_abs, t_abs


def check_expert(g, e=16, cap=20, din=5120, dout=8192):
    """One expert product (``e`` experts, capacity ``cap``; Llama-4-Scout's
    din 5120, dout 8192 by default; bf16 activations, w4 codes) through
    ``dense_expert``'s kernel route (one qmatmul launch an expert) against
    its plain version, bitwise; its max abs error (0)."""
    import torch
    from repro_torch.core.api import QuantConfig
    from repro_torch.kernels import dispatch
    from repro_torch.layers.moe import dense_expert
    p = {"w_q": torch.randint(-8, 8, (e, din, dout), generator=g,
                              device="cuda", dtype=torch.int8),
         "w_scale": torch.rand((e, 1, dout), generator=g, device="cuda")
         * 1e-2 + 1e-3}
    x = torch.randn((e, cap, din), generator=g, device="cuda").to(
        torch.bfloat16)
    qc = QuantConfig(w_bits=4, a_bits=8, mode="int", backend="cuda")
    before = dispatch.launch_counts()["qmatmul"]
    got = dense_expert(x, p, qc)
    torch.cuda.synchronize()
    n = dispatch.launch_counts()["qmatmul"] - before
    want = dense_expert(x, p, qc.replace(backend="torch"))
    same = torch.equal(got, want)
    diff = (got.float() - want.float()).abs().max().item()
    log(f"[check] expert product E={e} capacity={cap} din={din} dout={dout} "
        f"bf16 through qmatmul ({n} launches, plan "
        f"{dispatch.qmatmul_blocks(cap, dout, din)}) against dense_expert's "
        f"plain version: {'exact' if same else f'MISMATCH (max abs {diff})'}"
        f"; the transposed codes {e * din * dout / 1e9:.2f} GB")
    if not same or n != e:
        raise AssertionError("the expert product differs from its plain "
                             "version")
    return diff


def check_paged(g, row, bits, hkv=8):
    """The paged kernel at one ``PAGED_CHECKS`` / ``PAGED_LONG`` /
    ``PAGED_ARCHS`` row and prob grid against its plain version; its max
    abs error."""
    import torch
    from repro_torch.kernels import int_attention as ia
    from repro_torch.kernels import ref
    args, kw = paged_inputs(g, *row, bits=bits, hkv=hkv)
    out, codes = ia.int_paged_decode_attention(*args, return_codes=True,
                                               **kw)
    torch.cuda.synchronize()
    q, kp, vp, sc, vs, pt, pos = args
    want, wcodes = ref.int_paged_decode_attention_ref(
        q, kp, vp, sc, vs, pt, pos, attn_bits=bits, bk=kp.shape[2],
        window=kw["window"], k_page_scale=kw["k_page_scale"],
        v_page_scale=kw["v_page_scale"], return_codes=True)
    abs_e, rel_e = rel_err(out, want)
    same = torch.equal(codes, wcodes)
    idle = pos < 0
    idle_max = out[idle].abs().max().item() if bool(idle.any()) else 0.0
    log(f"[check] paged decode kv_bits={row[0]} Hkv={hkv} G={row[1]} "
        f"D={row[2]} pages {pt.shape[1]} pos {pos.tolist()} window "
        f"{kw['window']} "
        f"attn_bits={bits}: codes {'exact' if same else 'MISMATCH'}, out "
        f"max abs {abs_e:.3e} rel {rel_e:.3e} (tol rel {ATTN_RTOL}); "
        f"inactive rows {int(idle.sum())}, their max {idle_max:.1e}")
    if not same or rel_e > ATTN_RTOL or idle_max != 0:
        raise AssertionError("paged decode differs from its plain version")
    return abs_e


def check_ring(g, row, bits):
    """The ring kernel at one ``RING_CHECKS`` row and prob grid against its
    plain version; its max abs error."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import int_attention as ia
    kv_bits, span, pos, window, grp, d, *h = row
    args = ring_inputs(g, kv_bits, span, pos, grp, d, *h)
    kw = dict(attn_bits=bits, window=window, packed=kv_bits == 4,
              bk=dispatch.decode_blocks(span, d), return_codes=True)
    out, codes = ia.int_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    want, wcodes = ia.int_decode_attention_plain(*args, **kw)
    abs_e, rel_e = rel_err(out, want)
    same = torch.equal(codes, wcodes)
    log(f"[check] ring decode kv_bits={kv_bits} H={args[0].shape[0]} G={grp} "
        f"D={d} "
        f"span={span} pos={pos} window={window} bk={kw['bk']} "
        f"attn_bits={bits}: codes {'exact' if same else 'MISMATCH'}, out max "
        f"abs {abs_e:.3e} rel {rel_e:.3e} (tol rel {ATTN_RTOL})")
    if not same or rel_e > ATTN_RTOL:
        raise AssertionError("ring decode differs from its plain version")
    return abs_e


# The paper's low-bit prob grids (Table II's 2- and 3-bit models, and 4),
# checked beside 7 on every attention kernel: both prefill kernels at every
# ATTN_CASES shape, the paged kernel at the serve shape (kv8, kv4), the ring
# kernel at the ring phase's shape.
LOW_BITS = (2, 3, 4)
# (rows, d, dtype, bits, rms_only, beta, offset), checked and timed: the
# DeiT-S block (64 x 198 rows), the reference's kernel_bench shape,
# Qwen2.5-32B's width in bf16
PQLN_CASES = [(64 * 198, 384, "float32", 8, False, True, 0),
              (4096, 1024, "float32", 4, False, True, 0),
              (256, 5120, "bfloat16", 8, True, False, 0)]
# checked only: ragged widths (tail vectors; bf16 rows off 16 bytes), x
# starting one element into its buffer (every row takes element loads),
# LayerNorm without beta, 4 rows at Qwen2.5-32B's width, and the first
# widths above the kernel's register plan (rows re-read from global)
PQLN_CHECKS = PQLN_CASES + [(1000, 100, "float32", 8, False, True, 0),
                            (1000, 77, "bfloat16", 4, False, True, 0),
                            (64 * 198, 384, "float32", 8, False, True, 1),
                            (256, 5120, "bfloat16", 8, False, True, 1),
                            (64 * 198, 384, "float32", 8, False, False, 0),
                            (4, 5120, "bfloat16", 8, True, False, 0),
                            (16, 16385, "float32", 8, False, True, 0),
                            (8, 32769, "bfloat16", 8, True, False, 0)]
# (H, Sq, Sk, D, causal, bq, bk, sq_mod) of prefill attention, checked and
# timed on both the fused and the two-pass kernel.
ATTN_CASES = {
    # Qwen2.5-32B prefill as dispatch folds it: B 4 x Hkv 8 head-folds,
    # G 5 x 64 rows, 64 keys, causal; dispatch's blocks
    "qwen": (32, 320, 64, 128, True, 64, 64, 64),
    # DeiT-S through kernels/ops.py: 64 images x 6 heads, 198 tokens, the
    # reference kernel's bq = bk = 128
    "deit-ops": (384, 198, 198, 64, False, 128, 128, None),
    # DeiT-S through dispatch: one chunk of 198 rows, bq 33, bk 224
    "deit": (384, 198, 198, 64, False, 33, 224, None),
    # the [archs] prefill's odd and non-power-of-two head groups at 64
    # tokens: Yi-34B (G 7) and InternVL2-26B (G 6), B 4 x Hkv 8
    "yi": (32, 448, 64, 128, True, 64, 64, 64),
    "internvl2": (32, 384, 64, 128, True, 64, 64, 64),
}


# the fused kernel at the [recurrent] / [encdec] shapes, as dispatch folds
# them: name -> (H, G * Sq, Sk, D, causal, window, sq_mod, the query
# recalibration chunk; None for pre-quantized keys): RecurrentGemma-9B's
# local prefill (B 2 x Hkv 1, G 16 x 2304 rows, D 256, window 2048);
# Whisper-large-v3's encoder (B 4 x 20 heads, 1500 frames), decoder self
# and cross attention at prefill (32 tokens), and the cross attention of a
# decode step (one query row over 1500 int8 keys on their stored grid)
ATTN_FAMILIES = {
    "rg-local": (2, 16 * 2304, 2304, 256, True, 2048, 2304, 128),
    "wh-encoder": (80, 1500, 1500, 64, False, None, None, 125),
    "wh-self": (80, 32, 32, 64, True, None, None, 32),
    "wh-cross": (80, 32, 1500, 64, False, None, None, 32),
    "wh-cross-decode": (80, 1, 1500, 64, False, None, None, None),
}
# (kv_bits, span, pos, window, G, D, head-folds) of the ring kernel at the
# last decode step of [recurrent] and [encdec]: RecurrentGemma-9B's local
# ring of 2176 slots (window 2048 + q_chunk 128; B 2 x Hkv 1, G 16, D 256)
# and Whisper's self-attention ring of 64 (B 4 x 20 heads, G 1, D 64)
RING_FAMILIES = [(8, 2176, 2319, 2048, 16, 256, 2),
                 (8, 64, 47, None, 1, 64, 80)]


def family_attention_case(name):
    """An ``ATTN_FAMILIES`` row as ``attention_inputs`` takes it, with the
    blocks dispatch picks for it."""
    from repro_torch.kernels import dispatch
    h, sq, sk, d, causal, window, sq_mod, chunk = ATTN_FAMILIES[name]
    bq, bk = dispatch.attention_blocks(sq, sk, d, window=window, chunk=chunk)
    return h, sq, sk, d, causal, bq, bk, sq_mod, 7, window


def check_family_attention(g, name):
    """The fused kernel at one ``ATTN_FAMILIES`` shape: codes exact against
    its plain version, outputs within ATTN_RTOL; its max abs error."""
    import torch
    from repro_torch.kernels import int_attention as ia
    args, kw = attention_inputs(g, *family_attention_case(name))
    out, codes = ia.int_attention_fused(*args, return_codes=True, **kw)
    torch.cuda.synchronize()
    want, wcodes = ia.int_attention_fused_plain(*args, return_codes=True,
                                                **kw)
    abs_e, rel_e = rel_err(out, want)
    same = torch.equal(codes, wcodes)
    h, sq, d = args[0].shape
    log(f"[check] attention {name} H={h} Sq={sq} Sk={args[1].shape[1]} "
        f"D={d} causal={kw['causal']} window={kw['window']} bq={kw['bq']} "
        f"bk={kw['bk']}: fused codes {'exact' if same else 'MISMATCH'}, out "
        f"max abs {abs_e:.3e} rel {rel_e:.3e} (tol rel {ATTN_RTOL})")
    if not same or rel_e > ATTN_RTOL:
        raise AssertionError(f"attention {name}: the fused kernel differs")
    return abs_e


def pqln_inputs(g, rows, d, dtype, bits, rms_only, beta, offset):
    """x (rows, d), ``offset`` elements into its buffer, gamma, beta (or
    None) and a delta that puts |y| up to about 4 at the grid's edge."""
    import torch
    x = torch.randn((rows, d), generator=g, device="cuda") * 3 + \
        torch.randn((rows, 1), generator=g, device="cuda")
    buf = torch.empty((rows * d + offset,), dtype=getattr(torch, dtype),
                      device="cuda")
    x = buf[offset:].view(rows, d).copy_(x)
    gamma = torch.rand((d,), generator=g, device="cuda") + 0.5
    b = torch.randn((d,), generator=g, device="cuda") * 0.1 if beta \
        else None
    delta = 4.0 / ((1 << (bits - 1)) - 1)
    return (x, gamma, b, delta), dict(bits=bits, rms_only=rms_only)


def attention_inputs(g, h, sq, sk, d, causal, bq, bk, sq_mod, bits=7,
                     window=None):
    """Random int8 operands; one logit scale per (head-fold, q block);
    a ``bits``-bit prob grid; a local window."""
    import torch
    mk = lambda *shape: torch.randint(-127, 128, shape, generator=g,
                                      device="cuda", dtype=torch.int8)
    nq = -(-sq // bq)
    sc = (torch.rand((h, nq), generator=g, device="cuda") + 0.5) * 1e-4
    vs = (torch.rand((h,), generator=g, device="cuda") + 0.5) * 1e-2
    return (mk(h, sq, d), mk(h, sk, d), mk(h, sk, d), sc, vs), dict(
        attn_bits=bits, causal=causal, bq=bq, bk=bk, sq_mod=sq_mod,
        window=window)


# (kv_bits, span, pos, window, G, D): partly written (pos < span), wrapped
# (pos > span) and windowed rings of 1024 slots (bk 1024) and 8192 slots
# (bk 4096, two blocks) at the main path's G 5, D 128; then the widths the
# ring kernel refused before it was split across the card: chatglm3-6b's
# G 16 at D 128 over the full ring, RecurrentGemma-9B's local layers (G 16,
# D 256), and D 12 (byte loads).
RING_CHECKS = [(8, 1024, 79, None, 5, 128), (4, 1024, 79, None, 5, 128),
               (8, 1024, 5000, None, 5, 128), (4, 1024, 5000, None, 5, 128),
               (8, 8192, 79, None, 5, 128), (4, 8192, 79, None, 5, 128),
               (8, 8192, 20000, None, 5, 128), (4, 8192, 20000, None, 5, 128),
               (8, 8192, 9000, 3000, 5, 128), (4, 1024, 3000, 200, 5, 128),
               (8, 8192, 20000, None, 16, 128), (4, 8192, 9000, 3000, 16, 128),
               (8, 2048, 5000, None, 16, 256), (8, 1024, 3000, None, 5, 12)]
# (kv_bits, span, pos, window, G, D, head-folds), checked and timed: the
# one-launch kernel at Qwen2.5-32B's decode_32k on rank 0 of the 16 x 16
# mesh, its 8 rows by 8 KV heads over the whole 32768-slot ring (what
# [dryrun] (b) ran before the ring split by slot; its staged calls are
# RING_SPLIT's first row); RecurrentGemma-9B's long_500k, its one row's KV
# head over the 2176-slot local ring after 524287 tokens, window 2048 (at
# m = 16 a rank's 136 slots are not whole chunks: the ranks gather the
# ring and run this)
RING_DRYRUN = [(8, 32768, 32767, None, 5, 128, 64),
               (8, 2176, 524287, 2048, 16, 256, 1)]
# [ring-split] (kv_bits, span, pos, window, G, D, head-folds, ranks): the
# ring kernel's three launches as stages over a ring split by slot range
# across the model ranks, the exchanges done in this process, held bitwise
# to the one-launch kernel: Qwen2.5-32B's decode_32k ring on rank 0 of
# the 16 x 16 mesh ([dryrun] (b): 8 rows by 8 KV heads, G 5, 2048 slots a
# rank), kv4 with pos < span, wrapped and windowed; ChatGLM3-6B's 8192-slot
# ring at m = 4 ([tp] at four cards: 4 rows by 2 KV heads, G 16)
# [tp]'s ChatGLM3-6B at four cards: its ring of 8192 slots, 2048 a rank
TP_COLUMNS_RING = 8192
RING_SPLIT = [(8, 32768, 32767, None, 5, 128, 64, 16),
              (4, 32768, 20000, None, 5, 128, 64, 16),
              (8, 32768, 70000, 3000, 5, 128, 64, 16),
              (8, 8192, 8191, None, 16, 128, 8, 4),
              (4, 8192, 5000, None, 16, 128, 8, 4),
              (8, 8192, 20000, 3000, 16, 128, 8, 4)]
# (kv_bits, G, D): the serve path's shape, then G 16 at D 256 (the f32
# output carries in shared memory)
PAGED_CHECKS = [(8, 5, 128), (4, 5, 128), (8, 16, 256), (4, 16, 256)]
# (kv_bits, G, D, maxp, pos, window) at real context lengths, tables of
# 512 pages of 16: three rows of 8192 tokens and one of 5001 at the serve
# path's G 5 (kv8: 60.6 MB of live K and V, above the 50 MB L2; kv4), and
# G 16 at D 256 over a 2048-token window (RecurrentGemma-9B's local layers)
PAGED_LONG = [(8, 5, 128, 512, (8191, 8191, 5000, 8191), None),
              (4, 5, 128, 512, (8191, 8191, 5000, 8191), None),
              (8, 16, 256, 512, (8191, 8191, 8191, 8191), 2048)]
# (kv_bits, G, D, Hkv) at the serve shape: the [archs] head groups of
# ChatGLM3-6B, Yi-34B, Phi-3-medium (and Phi-3.5-MoE's G) and InternVL2-26B
PAGED_ARCHS = [(8, 16, 128, 2), (8, 7, 128, 8), (8, 4, 128, 10),
               (8, 6, 128, 8)]
# ((kv_bits, G, D, maxp, pos, window), Hkv): [serve-recurrent]'s
# RecurrentGemma-9B decode, B 2 at Hkv 1, tables of 256 pages (max_len
# 4096), both rows at their last step (2304 + 15: 2320 tokens written),
# a 2048-token window
PAGED_SERVE_REC = ((8, 16, 256, 256, (2319, 2319), 2048), 1)


def staged_ring(args, parts, bk, window, packed, return_codes=False):
    """The staged ring kernel (``int_attention.ring_stage_*``) on ``parts``
    slot ranges of the ring in ``args`` (as ``ring_inputs`` makes them),
    each rank's stages run in turn and the exchanges done here: the chunk
    maxima and Sigma partials concatenated in rank order, the per-block
    int32 PV summed.  Returns (out, codes of every rank in slot order)."""
    import torch
    from repro_torch.kernels import int_attention as ia
    q, k, v, sc, vs, kpos, posd = args
    h, g, d = q.shape
    n = k.shape[1] // parts
    chunk, ds = ia.staged_ring_plan(g, d, bk, n * parts, parts)
    sl = lambda t, j: t[:, j * n:(j + 1) * n].contiguous()
    stage1 = [ia.ring_stage_logits(q, sl(k, j), kpos[j * n:(j + 1) * n],
                                   posd, sc, chunk=chunk, ds=ds,
                                   window=window, packed=packed)
              for j in range(parts)]
    cm = torch.cat([c for _, c in stage1], 1)
    stage2 = [ia.ring_stage_pv(sl(v, j), stage1[j][0], cm,
                               c0=j * (n // chunk), bk=bk, chunk=chunk,
                               ds=ds, packed=packed,
                               return_codes=return_codes)
              for j in range(parts)]
    sp = torch.cat([s_ for s_, _, _ in stage2], 1)
    pvb = sum(p_ for _, p_, _ in stage2)
    out = ia.ring_stage_merge(sp, pvb, cm, vs, bk=bk, chunk=chunk)
    codes = torch.cat([c_ for _, _, c_ in stage2], -1) if return_codes \
        else None
    return out, codes


def staged_rank_call(args, parts, bk, window, packed):
    """What one rank (index 0) of the staged ring runs on the card: its
    stages, with the other ranks' maxima, partials and per-block PV taken
    as made (the exchanges left out), as a callable to time."""
    import torch
    from repro_torch.kernels import int_attention as ia
    q, k, v, sc, vs, kpos, posd = args
    h, g, d = q.shape
    n = k.shape[1] // parts
    chunk, ds = ia.staged_ring_plan(g, d, bk, n * parts, parts)
    k0, v0, kp0 = k[:, :n].contiguous(), v[:, :n].contiguous(), kpos[:n]
    x1, cm0 = ia.ring_stage_logits(q, k0, kp0, posd, sc, chunk=chunk, ds=ds,
                                   window=window, packed=packed)
    cm = torch.cat([cm0] + [torch.full_like(cm0, -1e30)] * (parts - 1), 1)
    sp0, pvb0, _ = ia.ring_stage_pv(v0, x1, cm, c0=0, bk=bk, chunk=chunk,
                                    ds=ds, packed=packed)
    sp = torch.cat([sp0] * parts, 1)

    def call():
        x, c = ia.ring_stage_logits(q, k0, kp0, posd, sc, chunk=chunk, ds=ds,
                                    window=window, packed=packed)
        ia.ring_stage_pv(v0, x, cm, c0=0, bk=bk, chunk=chunk, ds=ds,
                         packed=packed)
        return ia.ring_stage_merge(sp, pvb0, cm, vs, bk=bk, chunk=chunk)
    return call


def phase_ring_split(g, rows=None, timed=True):
    """[ring-split]: every RING_SPLIT row's staged ring (:func:`staged_ring`)
    bitwise equal to the one-launch kernel on the whole ring (outputs and
    codes), its plain stages (``ref.ring_*_ref``) to the three passes on
    the whole ring (``ref.int_decode_attention_chunked_ref``), the kernel
    within ATTN_RTOL of that; then rank 0's three stages timed (CUDA
    events and device time) beside the one-launch kernel on the whole ring
    and on rank 0's slots alone."""
    import torch
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import int_attention as ia
    t0 = time.perf_counter()
    for row in rows or RING_SPLIT:
        kv_bits, span, pos, window, grp, d, h, parts = row
        args = ring_inputs(g, kv_bits, span, pos, grp, d, h)
        packed, bk = kv_bits == 4, dispatch.decode_blocks(span, d)
        kw = dict(window=window, packed=packed, bk=bk)
        one, codes = ia.int_decode_attention(*args, return_codes=True, **kw)
        out, scodes = staged_ring(args, parts, bk, window, packed, True)
        torch.cuda.synchronize()
        same = torch.equal(out, one) and torch.equal(scodes, codes)
        q, k, v, sc, vs, kpos, posd = args
        n = span // parts
        ks, vs_ = (t.cpu() for t in (k, v))
        cpu = [t.cpu() for t in args]
        chunk = ia.staged_ring_plan(grp, d, bk, span, parts)[0]
        kw_ = dict(window=window, bk=bk, chunk=chunk)
        ku, vu = (ia.unpack_int4(t) if packed else t for t in cpu[1:3])
        want = ref.int_decode_attention_chunked_ref(cpu[0], ku, vu, *cpu[3:],
                                                    **kw_)
        pieces = []
        for j in range(parts):
            pieces.append((ks[:, j * n:(j + 1) * n], vs_[:, j * n:(j + 1) * n],
                           cpu[5][j * n:(j + 1) * n]))
        kk = [ks_ for ks_, _, _ in pieces]
        if packed:
            kk = [ia.unpack_int4(t) for t in kk]
        xs_cm = [ref.ring_logits_ref(cpu[0], kk[j], pieces[j][2], cpu[6],
                                     cpu[3], chunk=chunk, window=window)
                 for j in range(parts)]
        cm = torch.cat([c for _, c in xs_cm], 1)
        vv = [p_[1] for p_ in pieces]
        if packed:
            vv = [ia.unpack_int4(t) for t in vv]
        st2 = [ref.ring_pv_ref(vv[j], xs_cm[j][0], cm, c0=j * (n // chunk),
                               bk=bk, chunk=chunk) for j in range(parts)]
        plain = ref.ring_merge_ref(cm, torch.cat([a for a, _, _ in st2], 1),
                                   sum(b_ for _, b_, _ in st2), cpu[4], bk=bk,
                                   chunk=chunk)
        p_same = torch.equal(plain, want)
        abs_e, rel_e = rel_err(out, want.cuda())
        msg = (f"[ring-split] kv_bits={kv_bits} H={h} G={grp} D={d} "
               f"span={span} pos={pos} window={window} bk={bk} over {parts} "
               f"ranks of {n} slots ({n // chunk} chunks of {chunk}): staged "
               f"bitwise the one-launch kernel {same}, its plain stages "
               f"bitwise the three passes' plain version on the whole ring "
               f"{p_same}, out vs that rel {rel_e:.3e}")
        if timed:
            one_call = lambda: ia.int_decode_attention(*args, **kw)
            rank0 = staged_rank_call(args, parts, bk, window, packed)
            part_args = (q, k[:, :n].contiguous(), v[:, :n].contiguous(), sc,
                         vs, kpos[:n].contiguous(), posd)
            alone = lambda: ia.int_decode_attention(
                *part_args, window=window, packed=packed,
                bk=dispatch.decode_blocks(n, d))
            ms = {name: (cuda_ms(fn), device_ms(fn)) for name, fn in
                  (("rank", rank0), ("whole", one_call), ("slots", alone))}
            # rank 0's plain stages on the card, its bound (its live K/V
            # rows, q, the slot map, the ring's maxima and partials, its
            # per-block PV and the output) and bf16 SDPA over its live keys
            x0, cm0 = ref.ring_logits_ref(q, ia.unpack_int4(k[:, :n]) if
                                          packed else k[:, :n], kpos[:n],
                                          posd, sc, chunk=chunk,
                                          window=window)
            cmw = torch.cat([cm0] * parts, 1)
            v0 = ia.unpack_int4(v[:, :n]) if packed else v[:, :n]

            def plain():
                xs, _ = ref.ring_logits_ref(
                    q, ia.unpack_int4(k[:, :n]) if packed else k[:, :n],
                    kpos[:n], posd, sc, chunk=chunk, window=window)
                sp, pvb, _ = ref.ring_pv_ref(v0, xs, cmw, bk=bk, chunk=chunk)
                return ref.ring_merge_ref(cmw, torch.cat([sp] * parts, 1),
                                          pvb, vs, bk=bk, chunk=chunk)
            pms = cuda_ms(plain, iters=3, warmup=1)
            live = (kpos[:n] >= 0) & (kpos[:n] <= pos)
            if window is not None:
                live &= kpos[:n] > pos - window
            n_live, dk = int(live.sum()), k.shape[2]
            nch = span // chunk
            nblk = -(-nch // (bk // chunk))
            nbytes = q.numel() + 4 * n + 8 * h + 2 * h * n_live * dk + \
                4 * h * grp * (2 * nch + nblk * d) + 4 * h * grp * d
            bnd, by = bound_ms(nbytes, 4 * d * grp * h * n_live)
            lib = ring_sdpa_ms(g, h, max(n_live, 1), grp, d)
            msg += "; " + ", ".join(
                f"{name} {a:.4f} ms ({dev_str(b_)})" for name, (a, b_) in (
                    ("rank 0's three stages", ms["rank"]),
                    ("the one-launch kernel on the whole ring", ms["whole"]),
                    (f"on rank 0's {n} slots alone", ms["slots"])))
            msg += (f"; rank 0's bound {bnd:.4f} ms ({by}), its plain "
                    f"stages {pms:.4f} ms, bf16 SDPA over its {n_live} live "
                    f"keys {lib:.4f} ms")
        log(msg)
        if not same or not p_same or rel_e > ATTN_RTOL:
            raise AssertionError(f"[ring-split] {row}: the staged ring "
                                 f"differs")
    log(f"[ring-split] phase {time.perf_counter() - t0:.1f} s")


def model_config(backend):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import QuantConfig
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int",
                     backend=backend)
    return get_config("qwen2.5-32b").replace(n_layers=N_LAYERS, quant=qc)


SERVE_KERNELS = ("qmatmul", "int_attention_fused", "int_paged_decode_attention")


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
    if min(launches[k] for k in SERVE_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the paged path never launched: "
                             f"{launches}")
    plain = {k: snap[k] for k in ("qlinear_torch", "attention_torch",
                                  "attention_paged_torch")}
    if any(plain.values()):
        raise AssertionError(f"plain-path dispatches on the cuda run: {plain}")

    # The torch backend on the same inputs: first-step logits and tokens.
    tcfg = model_config("torch")
    for what, abs_e, rel_e in first_step_gaps(params, cfg, tcfg, prompts[:4],
                                              SERVE_KERNELS)[0]:
        log(f"[serve] {what} logits cuda vs torch backend: max abs "
            f"{abs_e:.3e} rel {rel_e:.3e} (tol rel {LOGITS_RTOL})")
        if rel_e > LOGITS_RTOL:
            raise AssertionError(f"{what} logits: cuda and torch differ")
    # where the gap comes from: the same first step at 2 of the 4 layers,
    # then the prefill layer by layer
    for what, abs_e, rel_e in first_step_gaps(
            params, cfg.replace(n_layers=2), tcfg.replace(n_layers=2),
            prompts[:4], SERVE_KERNELS)[0]:
        log(f"[serve] at 2 layers, {what} logits cuda vs torch backend: max "
            f"abs {abs_e:.3e} rel {rel_e:.3e} (printed only)")
    layer_attribution("[serve]", params, cfg, tcfg, prompts[:4])
    tgen, _ = serve(tcfg, params, prompts, **kw)
    agree = int((tgen == gen).sum())
    log(f"[serve] greedy tokens equal between backends: {agree}/{gen.size}")
    return launches, params


def padded_prompts(prompts):
    """Prompts right-padded into a (B, S) device batch."""
    import torch
    toks = torch.zeros((len(prompts), max(len(p) for p in prompts)),
                       dtype=torch.int32, device="cuda")
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p, device="cuda")
    return toks


# the dispatch counters of each backend's kernel route and plain path
CUDA_DISPATCH = ("qlinear_cuda", "qlinear_row_cuda", "qlinear_acc_cuda",
                 "qexpert_cuda", "attention_cuda", "attention_paged_cuda",
                 "attention_decode_cuda")
PLAIN_DISPATCH = ("qlinear_torch", "qlinear_row_torch", "qlinear_acc_torch",
                  "qexpert_torch", "attention_torch", "attention_paged_torch",
                  "attention_decode_torch")


PAGE = 16                 # page size of the paged runs and first steps


def engine_first_step(params, cfg, prompts, bucket, chunk, max_len,
                      tok=None):
    """The engine's first step on ``cfg``'s backend, one row a prompt,
    made of the calls it makes: every chunk of the cut plan (or the whole
    prompt) through ``lm.admission_prefill`` into the rows' pages, then one
    ``lm.decode_step`` from the prompts' ends on ``tok`` (the prefill's
    greedy tokens when None).  Returns (the final chunks' logits, the
    decode step's logits, ``tok``)."""
    import torch
    from repro_torch.models import lm
    b = len(prompts)
    maxp = -(-max_len // PAGE)
    cache = lm.init_paged_cache(cfg, b, max_len, page_size=PAGE,
                                device="cuda")
    table = torch.arange(b * maxp, dtype=torch.int32,
                         device="cuda").reshape(b, maxp)
    total = max(len(p) for p in prompts)
    c = chunk or total
    last = [None] * b
    for start in range(0, total, c):
        live = [i for i, p in enumerate(prompts) if len(p) > start]
        segs = [prompts[i][start:start + c] for i in live]
        toks = torch.zeros((len(live), bucket), dtype=torch.int32,
                           device="cuda")
        for j, seg in enumerate(segs):
            toks[j, :len(seg)] = torch.as_tensor(seg, device="cuda")
        lens = torch.tensor([len(seg) for seg in segs], dtype=torch.int32,
                            device="cuda")
        idx = torch.tensor(live, device="cuda")
        lg, cache = lm.admission_prefill(
            params, {"tokens": toks, "lengths": lens}, cfg, cache,
            idx.to(torch.int32), table[idx], prefix_len=start)
        for j, i in enumerate(live):
            if start + c >= len(prompts[i]):
                last[i] = lg[j]
    lg = torch.stack(last)
    cache["page_table"].copy_(table)
    cache["pos"].copy_(torch.tensor([len(p) for p in prompts],
                                    dtype=torch.int32, device="cuda"))
    if tok is None:
        tok = torch.argmax(lg[:, 0], -1).to(torch.int32)[:, None]
    lg2, _ = lm.decode_step(params, tok, cache, cfg)
    return lg, lg2, tok


def first_step_gaps(params, cfg, tcfg, prompts, ran, *, tag="", bucket=None,
                    chunk=None, max_len=None):
    """The paged path's first step (``engine_first_step``; by default one
    bucket of the longest prompt and room for 16 tokens) on the cuda
    backend, then on the torch backend from the cuda run's tokens:
    ``(what, max abs, max rel)`` of the prefill and the decode step's
    logits, and the cuda run's prefill logits.  Gates that each backend
    took its own path: the ``torch`` run launched no kernel and dispatched
    nothing to one, the ``cuda`` run launched every kernel in ``ran`` and
    dispatched nothing to the plain path."""
    import torch
    from repro_torch.kernels import dispatch
    s = max(len(p) for p in prompts)
    kw = dict(bucket=bucket or s, chunk=chunk, max_len=max_len or s + 16)
    logits, tok = {}, None
    for name, c in (("cuda", cfg), ("torch", tcfg)):
        torch.cuda.synchronize()
        dispatch.reset_stats()
        dispatch.reset_launches()
        lg, lg2, tok = engine_first_step(params, c, prompts, tok=tok, **kw)
        torch.cuda.synchronize()
        check_route(f"{tag}first step, {name} backend", name,
                    dispatch.launch_counts(), dispatch.snapshot(), ran)
        logits[name] = (lg.float(), lg2.float())
    gaps = [(what, *rel_err(logits["cuda"][i], logits["torch"][i]))
            for i, what in enumerate(("prefill", "first decode step"))]
    return gaps, logits["cuda"][0]


def check_route(what, backend, launches, snap, ran):
    """Gate one run's path: on ``cuda`` every kernel in ``ran`` launched
    and no plain dispatch; on ``torch`` no launch and no kernel dispatch."""
    if backend == "cuda":
        bad = [k for k in ran if launches[k] <= 0] + \
            [k for k in PLAIN_DISPATCH if snap[k]]
    else:
        bad = [k for k, n in launches.items() if n] + \
            [k for k in CUDA_DISPATCH if snap[k]]
    log(f"[route] {what}: launches "
        f"{ {k: n for k, n in launches.items() if n} }; dispatch "
        f"{ {k: snap[k] for k in CUDA_DISPATCH + PLAIN_DISPATCH if snap[k]} }")
    if bad:
        raise AssertionError(f"{what} did not take its path: {bad}")


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


# [archs]: every other decoder-only attention family the port serves, at
# its published widths with n_layers cut to ARCH_LAYERS
ARCHS = ("chatglm3-6b", "yi-34b", "phi3-medium-14b", "internvl2-26b",
         "llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b")
ARCH_LAYERS = 2
ARCH_GEN = 8
ARCH_RING = 1024          # InternVL2's ring: 256 patches + 64 tokens + 8


def arch_config(arch, backend):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import QuantConfig
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int",
                     backend=backend)
    return get_config(arch).replace(n_layers=ARCH_LAYERS, quant=qc)


def phase_archs():
    """ChatGLM3-6B, Yi-34B, Phi-3-medium, InternVL2-26B, Llama-4-Scout and
    Phi-3.5-MoE at their published widths (2 layers), each served on the
    cuda backend and held against the torch backend; InternVL2 also on the
    ring path with its 256 patch embeddings.  Returns the launches of every
    run, summed."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import integerize_params
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve, staggered_prompts
    from repro_torch.models import lm
    total = {}
    for arch in ARCHS:
        cfg, tcfg = arch_config(arch, "cuda"), arch_config(arch, "torch")
        moe = cfg.moe
        log(f"[archs] {arch}: published widths, n_layers cut "
            f"{get_config(arch).n_layers} -> {cfg.n_layers}; d_model "
            f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.kv_heads} (G "
            f"{cfg.n_heads // cfg.kv_heads}), head dim {cfg.hd}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}"
            + (f", {moe.n_experts} experts top-{moe.top_k}"
               f"{' + shared' if moe.shared_expert else ''}" if moe else "")
            + (f", rotary_frac {cfg.rotary_frac}" if cfg.rotary_frac < 1
               else "") + (", QKV bias" if cfg.qkv_bias else "")
            + (f", patch frontend ({cfg.n_patches})" if cfg.frontend else "")
            + f"; {cfg.dtype}, w4/a8/attn7/kv8, random weights from seed 0")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = integerize_params(
            lm.init_params(cfg.replace(quant=None), seed=0, device="cuda"),
            cfg.quant)                   # the float tree is freed here
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        prompts = staggered_prompts(4, 64, cfg.vocab)
        dispatch.reset_stats()
        dispatch.reset_launches()
        torch.cuda.synchronize()
        gen, stats = serve(cfg, params, prompts, gen_tokens=ARCH_GEN,
                           page_size=16, batch_size=4, audit_every=1)
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()
        snap = stats["dispatch"]
        statuses = [s["status"] for s in stats["per_seq"]]
        copies = sum(t.numel() for t in expert_copies(params))
        log(f"[archs] {arch} serve: 4 requests (prompts "
            f"{[len(p) for p in prompts]}), batch 4, {ARCH_GEN} tokens, "
            f"pages of 16: statuses {statuses}; {stats['engine_steps']} "
            f"engine steps in {stats['total_s']:.2f}s; weights made and "
            f"integerized in {t_init:.1f}s; launches {launches}; dispatch "
            f"qlinear {snap['qlinear_cuda']}/{snap['qlinear_torch']} qexpert "
            f"{snap['qexpert_cuda']}/{snap['qexpert_torch']} (cuda/torch); "
            f"transposed expert codes {copies / 1e9:.2f} GB; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
        if any(s != "done" for s in statuses):
            raise AssertionError(f"[archs] {arch}: not every request is "
                                 f"DONE: {statuses}")
        if stats["audit_violations"] or stats["failures"]["audit_failures"]:
            raise AssertionError(f"[archs] {arch}: audit "
                                 f"{stats['audit_violations']}")
        if min(launches[k] for k in SERVE_KERNELS) <= 0 or \
                (moe and snap["qexpert_cuda"] <= 0) or \
                any(snap[k] for k in PLAIN_DISPATCH):
            raise AssertionError(f"[archs] {arch}: launches {launches}, "
                                 f"dispatch {snap}")
        add_launches(total, launches)
        gaps, _ = first_step_gaps(params, cfg, tcfg, prompts, SERVE_KERNELS)
        for what, abs_e, rel_e in gaps:
            log(f"[archs] {arch} {what} logits cuda vs torch backend: max "
                f"abs {abs_e:.3e} rel {rel_e:.3e} (tol rel {LOGITS_RTOL})")
        flips, _ = layer_attribution(f"[archs] {arch}", params, cfg,
                                     tcfg, prompts)
        if max(rel_e for _, _, rel_e in gaps) > LOGITS_RTOL and not flips:
            raise AssertionError(f"[archs] {arch}: cuda and torch differ")
        if cfg.frontend == "patch":
            add_launches(total, arch_ring(params, cfg, tcfg))
        del params
        torch.cuda.empty_cache()
    log(f"[archs] launches over the six configurations: {total}")
    return total


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def expert_copies(params):
    """The transposed expert codes the kernel route made for ``params``."""
    for key, leaf in params.items():
        if isinstance(leaf, dict):
            yield from expert_copies(leaf)
        elif key == "w_q":
            yield from leaf.__dict__.get("_codes_t", {}).values()


def stack_blocks(params, cfg):
    """Each block's parameters and kind, in the stack's order (the
    ``units`` layers, then the remainder)."""
    from repro_torch.models import lm
    unit, n_units, rem = lm.unit_structure(cfg)
    for u in range(n_units):
        up = layer_at(params["units"], u)
        for j, kind in enumerate(unit):
            yield up[f"b{j}"], kind
    for i, kind in enumerate(rem):
        yield params[f"rem{i}"], kind


def layer_attribution(tag, params, cfg, tcfg, prompts):
    """The first step's prefill, layer by layer, the torch backend beside
    the cuda run (teacher-forced: each half block on the cuda run's
    stream, the ring phase's method): the mixer half's update gap (the
    attention, RG-LRU or SSD), the
    FFN half on the same input (bitwise: the expert route is float, the
    integer products exact), for MoE the tokens whose expert choice
    differs between the two backends' own normed streams; then the torch
    backend's own residual stream against the cuda run's after each layer
    (free-running), which shows how a gap grows, and for MoE the tokens
    that stream routes differently.  Under partitioned rules every rank
    runs it on its shard.  Returns the route flips, teacher-forced and
    free-running."""
    import torch
    from repro_torch.layers import moe
    from repro_torch.layers.embed import embed_lookup
    from repro_torch.layers.norms import apply_norm
    from repro_torch.models import lm
    toks = padded_prompts(prompts)
    b, s = toks.shape
    pos = torch.arange(s, dtype=torch.int32, device="cuda")[None].expand(b, s)
    x = embed_lookup(toks, params["embed"], cfg.tdtype, vocab=cfg.vocab)
    xt = x
    attn, flips, same, free, free_flips = [], [], [], [], []
    for p, kind in stack_blocks(params, cfg):
        x1 = lm.mixer_block(x, p, cfg, kind, positions=pos)
        x1t = lm.mixer_block(x, p, tcfg, kind, positions=pos)
        attn.append(rel_err(x1t - x, x1 - x)[1])
        if cfg.d_ff > 0:
            h2 = apply_norm(x1, p["ln2"], cfg.norm)
            if cfg.moe is not None:
                h2t = apply_norm(x1t, p["ln2"], cfg.norm)
                idx = moe.route(h2.reshape(b * s, -1), p["ffn"], cfg.moe)[2]
                idxt = moe.route(h2t.reshape(b * s, -1), p["ffn"],
                                 cfg.moe)[2]
                flips.append(int((idx != idxt).any(dim=-1).sum()))
            same.append(torch.equal(lm.ffn(h2, p, cfg)[0],
                                    lm.ffn(h2, p, tcfg)[0]))
        x = lm.ffn_block(x1, p, cfg)[0]
        x1f = lm.mixer_block(xt, p, tcfg, kind, positions=pos)
        if cfg.moe is not None:
            h2f = apply_norm(x1f, p["ln2"], cfg.norm)
            idxf = moe.route(h2f.reshape(b * s, -1), p["ffn"], cfg.moe)[2]
            free_flips.append(int((idx != idxf).any(dim=-1).sum()))
        xt = lm.ffn_block(x1f, p, tcfg)[0]
        free.append(rel_err(xt, x)[1])
    log(f"{tag} prefill layer by layer, teacher-forced: mixer update "
        f"max rel {' '.join(f'{e:.2e}' for e in attn)} (tol rel "
        f"{LOGITS_RTOL}); FFN on the same input bitwise equal {same}"
        + (f"; tokens routed differently by the two backends' own streams "
           f"{flips} of {b * s}" if cfg.moe is not None else "")
        + f"; free-running residual stream after each layer max rel "
        f"{' '.join(f'{e:.2e}' for e in free)}"
        + (f"; tokens the free-running stream routes differently "
           f"{free_flips}" if cfg.moe is not None else ""))
    if max(attn) > LOGITS_RTOL or not all(same):
        raise AssertionError(f"{tag}: teacher-forced layers differ")
    return sum(flips), sum(free_flips)


def arch_ring(params, cfg, tcfg):
    """InternVL2 on the ring path: ``lm.prefill`` of 256 patch embeddings
    (numpy seed 0) and 64 tokens into a ring of ARCH_RING slots, then
    ARCH_GEN greedy ``decode_step``s, held like ``[recurrent]``.  Returns
    the run's launches."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, RING_PROMPT), generator=g,
                         device="cuda", dtype=torch.int32)
    patches = torch.from_numpy(np.random.RandomState(0).randn(
        4, cfg.n_patches, cfg.d_model).astype(np.float32)).to("cuda")
    return hold_generation(
        "[archs] internvl2-26b ring", lm, params,
        {"tokens": toks, "patches": patches}, cfg, tcfg,
        ("qmatmul", "int_attention_fused", "int_decode_attention"),
        ARCH_RING, cfg.n_layers * ARCH_GEN, steps=ARCH_GEN)


# [recurrent] and [encdec]: the families whose blocks are not plain
# attention, at their published widths, w4/a8/attn7/kv8, seed 0
REC_STEPS = 16
RG_LAYERS = 5        # one (rglru, rglru, local) unit + the 2 remainder rglru
RG_BATCH, RG_PROMPT, RG_MAX_LEN = 2, 2304, 4096   # past the 2048 window
MAMBA_BATCH, MAMBA_PROMPT = 4, 512                # four SSD chunks of 128
WH_LAYERS = 4        # encoder and decoder layers each, of 32
WH_BATCH, WH_PROMPT, WH_MAX_LEN = 4, 32, 64


def family_config(arch, backend, **kw):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import QuantConfig
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int",
                     backend=backend)
    return get_config(arch).replace(quant=qc, **kw)


def hold_generation(tag, model, params, batch, cfg, tcfg, ran, max_len,
                    ring_launches, steps=REC_STEPS):
    """``model.prefill`` + ``steps`` greedy ``decode_step``s on the cuda
    backend, every count zeroed just before and read just after, a copy of
    the cache kept before each step; then the torch backend: prefill on the
    same inputs and each step teacher-forced (the cuda run's token and its
    cache copy).  Gates: the cuda run launched every kernel in ``ran`` and
    the ring kernel ``ring_launches`` times, nothing went to the plain
    path, the torch run launched nothing, ``pos`` the prompt (patches
    included) plus ``steps``, logits finite and within LOGITS_RTOL.
    Returns the cuda run's launches."""
    import torch
    from repro_torch.kernels import dispatch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_stats()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    lc, cache = model.prefill(params, batch, cfg, max_len=max_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    logits, fed, copies, step_s = [lc], [], [], 0.0
    for _ in range(steps):
        tok = torch.argmax(lc[:, 0], -1).to(torch.int32)[:, None]
        fed.append(tok)
        copies.append(clone_tree(cache))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lc, cache = model.decode_step(params, tok, cache, cfg)
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t1
        logits.append(lc)
    launches = dispatch.launch_counts()
    snap = dispatch.snapshot()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_route(f"{tag} cuda run", "cuda", launches, snap, ran)
    b, s = batch["tokens"].shape
    if "patches" in batch:
        s += batch["patches"].shape[1]
    pos = int(cache["pos"])
    dispatch.reset_stats()
    dispatch.reset_launches()
    lt, _ = model.prefill(params, batch, tcfg, max_len=max_len)
    worst = {"prefill": rel_err(lt.float(), logits[0].float())[1],
             "forced": 0.0}
    agree = int((torch.argmax(lt, -1) == torch.argmax(logits[0], -1)).sum())
    for i, (tok, c) in enumerate(zip(fed, copies)):
        lf, _ = model.decode_step(params, tok, c, tcfg)
        worst["forced"] = max(worst["forced"],
                              rel_err(lf.float(), logits[i + 1].float())[1])
        agree += int((torch.argmax(lf, -1) ==
                      torch.argmax(logits[i + 1], -1)).sum())
    torch.cuda.synchronize()
    check_route(f"{tag} torch run", "torch", dispatch.launch_counts(),
                dispatch.snapshot(), ())
    del copies
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    log(f"{tag} batch {b}, {s}-position prompts, max_len {max_len}, "
        f"{steps} decode steps: prefill {t_prefill:.2f}s, cuda decode step "
        f"{step_s / steps * 1e3:.2f} ms ({b * steps / step_s:.1f} tok/s), "
        f"pos {pos}, peak {peak:.2f} GB allocated; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    log(f"{tag} torch vs cuda backend max rel: prefill "
        f"{worst['prefill']:.3e}, each step teacher-forced "
        f"{worst['forced']:.3e} (tol rel {LOGITS_RTOL}); greedy tokens of "
        f"row 0 {torch.cat(fed, 1)[0].tolist()}; argmax equal "
        f"{agree}/{b * (steps + 1)} (printed only); finite {finite}")
    tok = torch.argmax(logits[-1][:, 0], -1).to(torch.int32)[:, None]
    model.decode_step(params, tok, cache, cfg)                 # warm
    log_profile(f"{tag} decode step", lambda: model.decode_step(
        params, tok, cache, cfg), 4, step_s / steps * 1e3)
    if launches["int_decode_attention"] != ring_launches or \
            pos != s + steps or not finite or \
            tuple(logits[-1].shape) != (b, 1, cfg.vocab) or \
            max(worst.values()) > LOGITS_RTOL:
        raise AssertionError(f"{tag} failed its gates")
    return launches


def phase_recurrent():
    """RecurrentGemma-9B (5 layers) and Mamba2-130M (all 24) generating on
    the ring path: RG-LRU / SSD blocks in plain PyTorch, every integer
    linear on qmatmul, RecurrentGemma's local attention on the fused and the
    ring kernels.  Returns the launches of every counted run, summed."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import integerize_params
    from repro_torch.examples import serve_mamba130m
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    total = {}
    t0 = time.perf_counter()
    cfg = family_config("recurrentgemma-9b", "cuda", n_layers=RG_LAYERS)
    tcfg = family_config("recurrentgemma-9b", "torch", n_layers=RG_LAYERS)
    unit, n_units, rem = lm.unit_structure(cfg)
    log(f"[recurrent] recurrentgemma-9b: published widths, n_layers cut "
        f"{get_config('recurrentgemma-9b').n_layers} -> {cfg.n_layers} "
        f"({n_units} unit {unit} + remainder {rem}); d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.kv_heads}, head dim {cfg.hd}, d_ff "
        f"{cfg.d_ff}, d_rnn {cfg.d_rnn}, window {cfg.attn_window} (local "
        f"ring {min(RG_MAX_LEN, cfg.attn_window + cfg.q_chunk)} slots), vocab "
        f"{cfg.vocab}, {cfg.dtype}, w4/a8/attn7/kv8, random weights from "
        f"seed 0")
    params = integerize_params(
        lm.init_params(cfg.replace(quant=None), seed=0, device="cuda"),
        cfg.quant)
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (RG_BATCH, RG_PROMPT), generator=g,
                         device="cuda", dtype=torch.int32)
    n_local = sum(k == "local" for k in lm.block_kinds(cfg))
    add_launches(total, hold_generation(
        "[recurrent] recurrentgemma-9b", lm, params, {"tokens": toks}, cfg,
        tcfg, ("qmatmul", "int_attention_fused", "int_decode_attention"),
        RG_MAX_LEN, n_local * REC_STEPS))
    del params
    torch.cuda.empty_cache()
    log(f"[recurrent] recurrentgemma-9b run in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    dispatch.reset_stats()
    out = serve_mamba130m.main(["--device", "cuda"])
    torch.cuda.synchronize()
    check_route("[recurrent] examples/serve_mamba130m.py", "cuda",
                out["launches"], dispatch.snapshot(), ("qmatmul",))
    if not out["finite"] or out["pos"] != 64 + 12:
        raise AssertionError(f"[recurrent] the Mamba example: {out}")
    add_launches(total, out["launches"])
    log(f"[recurrent] examples/serve_mamba130m.py (defaults: f32, batch 4, "
        f"64-token prompts, 12 tokens) in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    cfg = family_config("mamba2-130m", "cuda")
    tcfg = family_config("mamba2-130m", "torch")
    log(f"[recurrent] mamba2-130m: full size, {cfg.n_layers} SSD layers, "
        f"d_model {cfg.d_model}, d_state {cfg.ssd.d_state}, head dim "
        f"{cfg.ssd.head_dim}, chunk {cfg.ssd.chunk}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, w4/a8, random weights from seed 0")
    params = integerize_params(
        lm.init_params(cfg.replace(quant=None), seed=0, device="cuda"),
        cfg.quant)
    toks = torch.randint(0, cfg.vocab, (MAMBA_BATCH, MAMBA_PROMPT),
                         generator=g, device="cuda", dtype=torch.int32)
    add_launches(total, hold_generation(
        "[recurrent] mamba2-130m", lm, params, {"tokens": toks}, cfg, tcfg,
        ("qmatmul",), MAMBA_PROMPT + REC_STEPS, 0))
    del params
    torch.cuda.empty_cache()
    log(f"[recurrent] mamba2-130m run in {time.perf_counter() - t0:.1f}s; "
        f"launches over the three runs {total}")
    return total


# [serve-recurrent]: the recurrent families through the paged engine at the
# [recurrent] phase's widths; RecurrentGemma-9B three times: (a) both
# prompts fill their bucket in one chunk (where the reference serves a
# recurrent stack as its ring path does), (b) ragged prompts in one bucket,
# (c) (a) prefilled in chunks of 1024
RG_SERVE_RUNS = (("a", (RG_PROMPT, RG_PROMPT), None),
                 ("b", (RG_PROMPT, 1800), None),
                 ("c", (RG_PROMPT, RG_PROMPT), 1024))
SR_PROFILE_AT = 6         # the engine step after which 4 steps are profiled


def serve_engine(tag, params, cfg, prompts, ran, *, bucket, max_len,
                 chunk=None):
    """``PagedEngine`` over ``prompts`` on ``cfg``'s backend, one row a
    prompt, pages of 16, one prefill bucket, REC_STEPS greedy tokens,
    audited after every step; every count zeroed just before and read just
    after.  Four decode steps after step SR_PROFILE_AT run under the
    profiler and are left out of the step times.  Gates: every request
    DONE, no violation, a clean audit, the ``[route]`` of the path.
    Returns (each request's tokens, the launches)."""
    import statistics
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.engine import PagedEngine, Request
    eng = PagedEngine(cfg, params, batch_size=len(prompts), max_len=max_len,
                      page_size=PAGE, prefill_buckets=(bucket,),
                      prefill_chunk=chunk, audit_every=1)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=REC_STEPS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_stats()
    dispatch.reset_launches()
    pre, dec = [], []
    while True:
        chunks = eng.prefill_chunks
        t0 = time.perf_counter()
        more = eng.step()
        torch.cuda.synchronize()
        if not more:
            break
        (pre if eng.prefill_chunks > chunks else dec).append(
            time.perf_counter() - t0)
        if eng.step_count == SR_PROFILE_AT:
            log_profile(f"{tag} engine decode step", eng.step, 4,
                        statistics.median(dec) * 1e3)
    launches, snap = dispatch.launch_counts(), dispatch.snapshot()
    peak = torch.cuda.max_memory_allocated() / 1e9
    statuses = [r.status for r in reqs]
    timed = pre + dec
    log(f"{tag} engine: {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]}), bucket {bucket}, chunk {chunk}, "
        f"pages of {PAGE}, max_len {max_len}: statuses {statuses}; "
        f"{eng.step_count} engine steps, {eng.prefill_chunks} prefill "
        f"launches; {sum(timed) / len(timed) * 1e3:.2f} ms per engine step "
        f"(prefill included; {len(timed)} steps timed), prefill step(s) "
        f"{' '.join(f'{t * 1e3:.2f}' for t in pre)} ms, decode step median "
        f"{statistics.median(dec) * 1e3:.2f} ms mean "
        f"{sum(dec) / len(dec) * 1e3:.2f} ms "
        f"({len(prompts) * len(dec) / sum(dec):.1f} tok/s); peak "
        f"{peak:.2f} GB allocated; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    check_route(f"{tag} engine run", cfg.quant.backend, launches, snap, ran)
    if any(s != "done" for s in statuses) or eng.violations or eng.audit():
        raise AssertionError(f"{tag}: statuses {statuses}, violations "
                             f"{eng.violations}")
    return [r.tokens for r in reqs], launches


def log_gaps(tag, gaps):
    for what, abs_e, rel_e in gaps:
        log(f"{tag} first step, {what} logits cuda vs torch backend: max "
            f"abs {abs_e:.3e} rel {rel_e:.3e} (tol rel {LOGITS_RTOL})")


def ring_generation(params, cfg, prompts, max_len):
    """``lm.prefill`` of the prompts (equal lengths) into a ring of
    ``max_len`` slots and greedy ``decode_step``s: (the prefill's logits,
    each row's REC_STEPS tokens)."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    toks = torch.as_tensor(np.stack(prompts), device="cuda")
    lg, cache = lm.prefill(params, {"tokens": toks}, cfg, max_len=max_len)
    first, out = lg.float(), []
    for i in range(REC_STEPS):
        tok = torch.argmax(lg[:, 0], -1).to(torch.int32)[:, None]
        out.append(tok)
        if i < REC_STEPS - 1:
            lg, cache = lm.decode_step(params, tok, cache, cfg)
    return first, torch.cat(out, 1).tolist()


def phase_serve_recurrent():
    """RecurrentGemma-9B (5 layers; runs a, b, c) and Mamba2-130M (all 24)
    served by the paged engine on the cuda backend: every integer linear on
    qmatmul, RecurrentGemma's local layer on the fused kernel at admission
    and the paged kernel at decode.  Gates each run (``serve_engine``, and
    the first step against the torch backend); where the reference serves
    as its ring path does (RecurrentGemma (a), Mamba), the first-step
    logits (RecurrentGemma) or the tokens (Mamba) against the ring
    generation on the same backend.  Returns the launches of every engine
    run, summed."""
    import numpy as np
    import torch
    from repro_torch.core.api import integerize_params
    from repro_torch.models import lm
    total = {}
    rng = np.random.RandomState(1)
    t0 = time.perf_counter()
    cfg = family_config("recurrentgemma-9b", "cuda", n_layers=RG_LAYERS)
    tcfg = family_config("recurrentgemma-9b", "torch", n_layers=RG_LAYERS)
    log(f"[serve-recurrent] recurrentgemma-9b: the [recurrent] widths at "
        f"{cfg.n_layers} layers, batch {RG_BATCH}, bf16, w4/a8/attn7/kv8, "
        f"random weights from seed 0; {REC_STEPS} greedy tokens a request")
    params = integerize_params(
        lm.init_params(cfg.replace(quant=None), seed=0, device="cuda"),
        cfg.quant)
    base = [rng.randint(0, cfg.vocab, RG_PROMPT).astype(np.int32)
            for _ in range(RG_BATCH)]
    for name, lens, chunk in RG_SERVE_RUNS:
        tag = f"[serve-recurrent] recurrentgemma-9b ({name})"
        prompts = [p[:n] for p, n in zip(base, lens)]
        kw = dict(bucket=RG_PROMPT, chunk=chunk, max_len=RG_MAX_LEN)
        toks, launches = serve_engine(tag, params, cfg, prompts,
                                      SERVE_KERNELS, **kw)
        add_launches(total, launches)
        gaps, lg = first_step_gaps(params, cfg, tcfg, prompts,
                                   SERVE_KERNELS, tag=f"{tag} ", **kw)
        log_gaps(tag, gaps)
        bad = max(rel_e for _, _, rel_e in gaps) > LOGITS_RTOL
        if name == "a":
            ring_lg, ring = ring_generation(params, cfg, prompts, RG_MAX_LEN)
            abs_e, rel_e = rel_err(lg, ring_lg)
            agree = sum(int(a == b) for x, y in zip(toks, ring)
                        for a, b in zip(x, y))
            log(f"{tag} engine vs ring generation, cuda backend: prefill "
                f"logits max abs {abs_e:.3e} rel {rel_e:.3e} (tol rel "
                f"{LOGITS_RTOL}); greedy tokens equal {agree}/"
                f"{RG_BATCH * REC_STEPS} (printed only: the local layer's "
                f"KV grid is per sequence and page in the engine, per "
                f"tensor in the ring)")
            bad = bad or rel_e > LOGITS_RTOL
        if bad:
            layer_attribution(tag, params, cfg, tcfg, prompts)
            raise AssertionError(f"{tag}: first-step logits past the gate")
    del params
    torch.cuda.empty_cache()
    log(f"[serve-recurrent] recurrentgemma-9b in "
        f"{time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    tag = "[serve-recurrent] mamba2-130m"
    cfg = family_config("mamba2-130m", "cuda")
    tcfg = family_config("mamba2-130m", "torch")
    params = integerize_params(
        lm.init_params(cfg.replace(quant=None), seed=0, device="cuda"),
        cfg.quant)
    prompts = [rng.randint(0, cfg.vocab, MAMBA_PROMPT).astype(np.int32)
               for _ in range(MAMBA_BATCH)]
    kw = dict(bucket=MAMBA_PROMPT, max_len=MAMBA_PROMPT + REC_STEPS)
    toks, launches = serve_engine(tag, params, cfg, prompts, ("qmatmul",),
                                  **kw)
    add_launches(total, launches)
    gaps, _ = first_step_gaps(params, cfg, tcfg, prompts, ("qmatmul",),
                              tag=f"{tag} ", **kw)
    log_gaps(tag, gaps)
    _, ring = ring_generation(params, cfg, prompts, kw["max_len"])
    log(f"{tag} engine tokens equal to the ring generation's (cuda "
        f"backend): {toks == ring}; row 0 {toks[0]}")
    if max(rel_e for _, _, rel_e in gaps) > LOGITS_RTOL or toks != ring:
        layer_attribution(tag, params, cfg, tcfg, prompts)
        raise AssertionError(f"{tag} failed its gates")
    del params
    torch.cuda.empty_cache()
    log(f"[serve-recurrent] mamba2-130m in {time.perf_counter() - t0:.1f}s; "
        f"launches over the four engine runs {total}")
    return total


def phase_encdec():
    """Whisper-large-v3 (4 + 4 layers) generating: the encoder over seeded
    stub frames, the decoder's self-attention ring and its cross-attention
    over the int8 cross K/V; every integer linear on qmatmul, every prefill
    and cross attention on the fused kernel, each self-attention decode
    step on the ring kernel.  Returns the run's launches."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import integerize_params
    from repro_torch.models import encdec
    t0 = time.perf_counter()
    cfg = family_config("whisper-large-v3", "cuda", n_enc_layers=WH_LAYERS,
                        n_dec_layers=WH_LAYERS)
    tcfg = family_config("whisper-large-v3", "torch", n_enc_layers=WH_LAYERS,
                         n_dec_layers=WH_LAYERS)
    full = get_config("whisper-large-v3")
    log(f"[encdec] whisper-large-v3: published widths, layers cut "
        f"{full.n_enc_layers} + {full.n_dec_layers} -> {cfg.n_enc_layers} + "
        f"{cfg.n_dec_layers}; d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"head dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.n_audio_ctx} frames, {cfg.dtype}, w4/a8/attn7/kv8, random "
        f"weights from seed 0")
    params = integerize_params(
        encdec.init_params(cfg.replace(quant=None), seed=0, device="cuda"),
        cfg.quant)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"frames": torch.randn((WH_BATCH, cfg.n_audio_ctx, cfg.d_model),
                                   generator=g, device="cuda"),
             "tokens": torch.randint(0, cfg.vocab, (WH_BATCH, WH_PROMPT),
                                     generator=g, device="cuda",
                                     dtype=torch.int32)}
    launches = hold_generation(
        "[encdec] whisper-large-v3", encdec, params, batch, cfg, tcfg,
        ("qmatmul", "int_attention_fused", "int_decode_attention"),
        WH_MAX_LEN, cfg.n_dec_layers * REC_STEPS)
    # fused: the encoder's, the decoder's self and cross attention at
    # prefill, and the cross attention of every decode step
    want = cfg.n_enc_layers + 2 * cfg.n_dec_layers + \
        cfg.n_dec_layers * REC_STEPS
    if launches["int_attention_fused"] != want:
        raise AssertionError(f"[encdec] fused launches "
                             f"{launches['int_attention_fused']}, expected "
                             f"{want}")
    del params
    torch.cuda.empty_cache()
    log(f"[encdec] run in {time.perf_counter() - t0:.1f}s")
    return launches


# [dist]: the distributed layer (src/repro_torch/distributed) on NCCL, one
# rank a card, on a (data 1, model n) mesh: Qwen2.5-32B widths through the
# row-parallel shard body, Llama-4-Scout widths through the all-to-all
DIST_LAYERS = 2
DIST_BATCH, DIST_PROMPT, DIST_STEPS = 4, 256, 16
DIST_KERNELS = ("qmatmul", "int_attention_fused", "int_decode_attention")
DIST_JOIN_S = 600
DIST_MICRO = 8            # pipeline microbatches of DIST_BATCH rows


DIST_STEPS_ALL = ("dist", "tp", "tp-shard-bodies", "tp-families",
                  "tp-train")


def phase_dist(only=DIST_STEPS_ALL):
    """Spawn ``torch.cuda.device_count()`` ranks, one a card, on NCCL
    (``dist_rank``), and wait for them; returns rank 0's launches of each
    step of ``only`` (all of them by default), by step: the [dist] main
    path (the Qwen and Llama-4 runs), [tp]'s (the partitioned runs of
    (a)), [tp-families]' (its partitioned runs) and [tp-train]'s (serving
    (a)'s trained trees)."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp(prefix="dist")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(r, n, d, tuple(only)))
             for r in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        # a rank that fails leaves the others waiting in a collective:
        # stop them all then, rather than at the deadline
        while any(p.is_alive() for p in procs) and \
                not any(p.exitcode for p in procs) and \
                time.perf_counter() - t0 < DIST_JOIN_S:
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"[dist] rank exit codes {codes}")
    with open(os.path.join(d, "launches.json")) as f:
        launches = json.load(f)
    log(f"[dist] {n} rank(s) in {time.perf_counter() - t0:.1f}s; rank 0's "
        f"launches {launches}")
    return launches


def dist_rank(rank, world, d, only):
    """One [dist] rank: card ``rank``, NCCL through a file store in ``d``;
    rank 0 logs and writes its launches to ``d``."""
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{d}/store",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=DIST_JOIN_S))
    try:
        launches = dist_run(rank, world, only)
        if rank == 0:
            with open(os.path.join(d, "launches.json"), "w") as f:
                json.dump(launches, f)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def dist_run(rank, world, only=DIST_STEPS_ALL):
    """The steps of ``only`` on this rank, in order: the [dist] phase,
    [tp], [tp-families] and [tp-train]; returns their main-path launches,
    by step."""
    import torch
    from repro_torch.distributed.sharding import Rules
    from repro_torch.launch.mesh import make_test_mesh
    say = log if rank == 0 else (lambda *a: None)
    out = {}
    with torch.no_grad():
        if "dist" in only:
            mesh = make_test_mesh((1, world), ("data", "model"),
                                  device_type="cuda")
            rules = Rules(batch=("data",), mesh=mesh, int_bf16_reduce=True,
                          moe_a2a=True)
            say(f"[dist] {world} rank(s) on NCCL, mesh (data 1, model "
                f"{world}); Rules(batch=('data',), int_bf16_reduce, "
                f"moe_a2a)")
            total = {}
            add_launches(total, dist_qwen(rules, world, say))
            add_launches(total, dist_llama(rules, world, say))
            dist_compress(mesh, rank, world, say)
            dist_pipeline(world, say)
            out["dist"] = {k: total.get(k, 0) for k in DIST_KERNELS}
        if "tp" in only:
            out["tp"] = dist_tp(rank, world, say)
        if "tp-shard-bodies" in only:
            out["tp-shard-bodies"] = dist_tp_shard_bodies(rank, world, say)
        if "tp-families" in only:
            out["tp-families"] = dist_tp_families(rank, world, say)
    torch.cuda.empty_cache()
    if "tp-train" in only:
        out["tp-train"] = dist_train(rank, world, say)
    return out


def dist_gap(got, want, world):
    """(max abs, max rel, in one bf16 ulp): bitwise at one rank, else
    within one bf16 ulp of each value (the collectives sum f32 partials in
    NCCL's order)."""
    import torch
    abs_e, rel_e = rel_err(got.float(), want.float())
    if world == 1:
        return abs_e, rel_e, torch.equal(got, want)
    tol = 2.0 ** -7 * want.float().abs() + 1e-30
    return abs_e, rel_e, bool(((got.float() - want.float()).abs()
                               <= tol).all())


def dist_qwen(rules, world, say):
    """Qwen2.5-32B widths, 2 layers: ``lm.prefill`` of 4 x 256 tokens and
    16 greedy ring steps under the rules on the cuda backend (every count
    zeroed before, read after), the torch backend teacher-forced beside it;
    then both row-parallel linears of layer 0 alone, cuda against torch, at
    prefill and decode rows, and their times.  Returns the run's
    launches."""
    import torch
    from repro_torch.core.api import dense, integerize_params
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    cfg = arch_config("qwen2.5-32b", "cuda").replace(n_layers=DIST_LAYERS)
    tcfg = cfg.replace(quant=cfg.quant.replace(backend="torch"))
    params = integerize_params(
        lm.init_params(cfg.replace(quant=None), seed=0, device="cuda"),
        cfg.quant)
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (DIST_BATCH, DIST_PROMPT),
                         generator=g, device="cuda", dtype=torch.int32)
    max_len = DIST_PROMPT + DIST_STEPS
    with use_rules(rules):
        # a first prefill sets up cuBLAS and NCCL's communicators lazily
        t0 = time.perf_counter()
        lm.prefill(params, {"tokens": toks}, cfg, max_len)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_stats()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        lc, cache = lm.prefill(params, {"tokens": toks}, cfg, max_len)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        logits, fed, copies, step_s = [lc], [], [], 0.0
        for _ in range(DIST_STEPS):
            tok = torch.argmax(lc[:, 0], -1).to(torch.int32)[:, None]
            fed.append(tok)
            copies.append(clone_tree(cache))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lc, cache = lm.decode_step(params, tok, cache, cfg)
            torch.cuda.synchronize()
            step_s += time.perf_counter() - t1
            logits.append(lc)
        launches = dispatch.launch_counts()
        snap = dispatch.snapshot()
        peak = torch.cuda.max_memory_allocated() / 1e9
        rows = snap["qlinear_row_cuda"]
        want_rows = 2 * cfg.n_layers * (1 + DIST_STEPS)
        check_route("[dist] qwen2.5-32b cuda run", "cuda", launches, snap,
                    DIST_KERNELS)
        if rows != want_rows or \
                launches["int_decode_attention"] != cfg.n_layers * DIST_STEPS:
            raise AssertionError(f"[dist] qwen: row-parallel products {rows} "
                                 f"(want {want_rows}), launches {launches}")
        dispatch.reset_stats()
        dispatch.reset_launches()
        lt, _ = lm.prefill(params, {"tokens": toks}, tcfg, max_len)
        gaps = [dist_gap(logits[0], lt, world)]
        for i, (tok, c) in enumerate(zip(fed, copies)):
            lf, _ = lm.decode_step(params, tok, c, tcfg)
            gaps.append(dist_gap(logits[i + 1], lf, world))
        torch.cuda.synchronize()
        check_route("[dist] qwen2.5-32b torch run", "torch",
                    dispatch.launch_counts(), dispatch.snapshot(), ())
    del copies
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    worst = max(rel for _, rel, _ in gaps)
    same = sum(ok for _, _, ok in gaps)
    apart = [i for i, (_, _, ok) in enumerate(gaps) if not ok]
    say(f"[dist] qwen2.5-32b widths, {cfg.n_layers} layers, batch "
        f"{DIST_BATCH}, {DIST_PROMPT}-token prompts, {DIST_STEPS} ring steps: "
        f"prefill {t_prefill * 1e3:.2f} ms (the first {t_cold * 1e3:.2f}), "
        f"decode step "
        f"{step_s / DIST_STEPS * 1e3:.2f} ms ({DIST_BATCH * DIST_STEPS / step_s:.1f} "
        f"tok/s), peak {peak:.2f} GB allocated; row-parallel products "
        f"{rows} (2 a layer a forward); launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    say(f"[dist] qwen2.5-32b torch vs cuda backend (teacher-forced): max rel "
        f"{worst:.3e} (tol rel {LOGITS_RTOL}); "
        f"{'bitwise' if world == 1 else 'within one bf16 ulp'} in {same} of "
        f"{len(gaps)} forwards (not in {apart}: 0 the prefill, i decode "
        f"step i); greedy tokens of row 0 "
        f"{torch.cat(fed, 1)[0].tolist()}; finite {finite}")
    if worst > LOGITS_RTOL or not finite:
        raise AssertionError("[dist] qwen2.5-32b: cuda and torch differ")
    tok = torch.argmax(logits[-1][:, 0], -1).to(torch.int32)[:, None]
    with use_rules(rules):
        step = lambda: lm.decode_step(params, tok, cache, cfg)
        step()                                              # warm
        if world_rank() == 0:
            log_profile("[dist] qwen2.5-32b decode step", step, 4,
                        step_s / DIST_STEPS * 1e3)
        else:                  # the same collectives, unprofiled
            for _ in range(4):
                step()
    # the two row-parallel linears of layer 0 alone
    p0 = layer_at(params["units"], 0)["b0"]
    for name, p, k in (("wo", p0["attn"]["wo"], cfg.n_heads * cfg.hd),
                       ("down", p0["ffn"]["down"], cfg.d_ff)):
        for s in (DIST_PROMPT, 1):
            x = torch.randn((DIST_BATCH, s, k), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            with use_rules(rules):
                got = dense(x, p, cfg.quant, tp="row")
                want = dense(x, p, tcfg.quant, tp="row")
                ms = cuda_ms(lambda: dense(x, p, cfg.quant, tp="row"))
            plain_ms = cuda_ms(lambda: dense(x, p, cfg.quant))
            abs_e, _, ok = dist_gap(got, want, world)
            parts = row_parallel_parts(x, p, cfg.quant, rules)
            say(f"[dist] row-parallel {name} x ({DIST_BATCH}, {s}, {k}) -> "
                f"N {p['w_q'].shape[0]}, the rank's K {k // world}: cuda vs "
                f"torch max abs {abs_e:.3e} "
                f"({'bitwise' if world == 1 else 'one bf16 ulp'}: {ok}); "
                f"{ms:.4f} ms (event) against {plain_ms:.4f} ms for the "
                f"replicated dense on the same card; alone (ms, and the bus "
                f"bandwidth): "
                + ", ".join(f"{k_} {v:.4f}" for k_, v in parts.items()))
            if not ok:
                raise AssertionError(f"[dist] row-parallel {name} differs")
    del params
    torch.cuda.empty_cache()
    return launches


def world_rank():
    import torch.distributed as dist
    return dist.get_rank()


def row_parallel_parts(x, p, qc, rules):
    """The shard body's steps timed alone (CUDA events) on this rank's
    slices: the per-tensor quantizer, qmatmul on the K slice, the f32
    reduce-scatter and the bf16 all-gather."""
    import torch
    from repro_torch.core import quant
    from repro_torch.distributed import collectives as col
    from repro_torch.kernels.dispatch import maybe_qlinear_row, row_codes
    mesh = rules.mesh
    m, j = col.axes_size(mesh, ("model",)), col.axes_index(mesh, ("model",))
    grp = col.group(mesh, "model")
    kl, n = x.shape[-1] // m, p["w_q"].shape[0]
    xl = x[..., j * kl:(j + 1) * kl]
    xq = quant.quantize_tensor(xl, qc.a_bits)
    codes = xq.q.reshape(-1, kl)
    scale = (p["w_scale"] * xq.scale).to(torch.float32)
    w = row_codes(p["w_q"], j, m)
    y = maybe_qlinear_row(codes, w, scale, qc)
    rows = codes.shape[0]
    ys = y.reshape(rows, m, n // m).transpose(0, 1).contiguous()
    part = col.reduce_scatter0(ys, grp).to(torch.bfloat16)
    rs = cuda_ms(lambda: col.reduce_scatter0(ys, grp))
    ag = cuda_ms(lambda: col.gather0(part, grp))
    # bus bytes a rank moves: (m - 1) / m of the f32 partials, and of the
    # gathered bf16 result
    bus = (m - 1) / m * ys.numel() * 4, (m - 1) * part.numel() * 2
    return {"quantize": cuda_ms(lambda: quant.quantize_tensor(xl, qc.a_bits)),
            "qmatmul": cuda_ms(lambda: maybe_qlinear_row(codes, w, scale,
                                                         qc)),
            "reduce-scatter": rs, "all-gather": ag,
            "reduce-scatter GB/s": bus[0] / rs / 1e6,
            "all-gather GB/s": bus[1] / ag / 1e6}


def dist_llama(rules, world, say):
    """Llama-4-Scout widths, 2 layers: the forward of 4 x 256 tokens under
    the rules (every MoE FFN through ``moe_ffn_a2a``) on the cuda backend,
    against the torch backend (a miss allowed only where a route flip
    explains it, attributed layer by layer); the a2a FFN of layer 0 alone,
    cuda against torch.  Returns the run's launches."""
    import torch
    from repro_torch.core.api import integerize_params
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.layers import moe
    from repro_torch.models import lm
    cfg = arch_config("llama4-scout-17b-a16e", "cuda").replace(
        n_layers=DIST_LAYERS)
    tcfg = cfg.replace(quant=cfg.quant.replace(backend="torch"))
    params = integerize_params(
        lm.init_params(cfg.replace(quant=None), seed=0, device="cuda"),
        cfg.quant)
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (DIST_BATCH, DIST_PROMPT),
                         generator=g, device="cuda", dtype=torch.int32)
    with use_rules(rules):
        t0 = time.perf_counter()
        lm.forward(params, {"tokens": toks}, cfg)              # cold
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        dispatch.reset_stats()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        x, _, aux = lm.forward(params, {"tokens": toks}, cfg)
        lc = lm.logits_fn(params, x[:, -1:], cfg)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        launches = dispatch.launch_counts()
        snap = dispatch.snapshot()
        check_route("[dist] llama4-scout cuda run", "cuda", launches, snap,
                    ("qmatmul", "int_attention_fused"))
        if snap["qexpert_cuda"] <= 0:
            raise AssertionError(f"[dist] llama4: no expert product {snap}")
        dispatch.reset_stats()
        dispatch.reset_launches()
        xt, _, auxt = lm.forward(params, {"tokens": toks}, tcfg)
        lt = lm.logits_fn(params, xt[:, -1:], tcfg)
        abs_e, rel_e = rel_err(lt.float(), lc.float())
        flips = 0
        if rel_e > LOGITS_RTOL:
            flips, _ = layer_attribution("[dist] llama4-scout", params, cfg,
                                      tcfg, [r.tolist() for r in toks])
        p0 = layer_at(params["units"], 0)["b0"]
        h = torch.randn((DIST_BATCH * DIST_PROMPT, cfg.d_model), generator=g,
                        device="cuda", dtype=torch.bfloat16)
        dispatch.reset_stats()
        got, _ = moe.moe_ffn(h, p0["ffn"], cfg.moe, cfg.quant, act=cfg.act)
        n_exp = dispatch.STATS["qexpert_cuda"]
        want, _ = moe.moe_ffn(h, p0["ffn"], cfg.moe, tcfg.quant, act=cfg.act)
        ms = cuda_ms(lambda: moe.moe_ffn(h, p0["ffn"], cfg.moe, cfg.quant,
                                         act=cfg.act), iters=5, warmup=1)
    dense_ms = cuda_ms(lambda: moe.moe_ffn(h, p0["ffn"], cfg.moe, cfg.quant,
                                           act=cfg.act), iters=5, warmup=1)
    f_abs, _, ok = dist_gap(got, want, world)
    e_loc = cfg.moe.n_experts // world
    say(f"[dist] llama4-scout widths, {cfg.n_layers} layers, "
        f"{cfg.moe.n_experts} experts ({e_loc} a rank) top-{cfg.moe.top_k} "
        f"+ shared, forward of {DIST_BATCH} x {DIST_PROMPT} tokens "
        f"{t_fwd * 1e3:.2f} ms (the first {t_cold * 1e3:.2f}), lb_loss {float(aux):.4f} (torch "
        f"{float(auxt):.4f}); launches "
        f"{ {k: n for k, n in launches.items() if n} }, expert products "
        f"{snap['qexpert_cuda']}; last-position logits torch vs cuda max abs "
        f"{abs_e:.3e} rel {rel_e:.3e} (tol rel {LOGITS_RTOL}; route flips "
        f"{flips})")
    say(f"[dist] a2a FFN of layer 0 alone, {DIST_BATCH * DIST_PROMPT} "
        f"tokens: cuda vs torch max abs {f_abs:.3e} "
        f"({'bitwise' if world == 1 else 'one bf16 ulp'}: {ok}); {n_exp} "
        f"expert products; {ms:.3f} ms (event) against {dense_ms:.3f} ms for "
        f"the replicated dense dispatch on the same card")
    if (rel_e > LOGITS_RTOL and not flips) or not ok:
        raise AssertionError("[dist] llama4-scout: cuda and torch differ")
    del params
    torch.cuda.empty_cache()
    return launches


def dist_compress(mesh, rank, world, say):
    """``compress_psum`` over one Qwen2.5-32B layer's gradient shapes (bf16,
    each rank its own, seed 100 + rank), against the same arithmetic on
    every rank's gradients gathered (bitwise); its time beside a bf16
    all-reduce of the same tree."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import (compress_psum,
                                                     init_error_buffer)
    g = torch.Generator(device="cuda").manual_seed(100 + rank)
    shapes = {"wq": (5120, 5120), "wkv": (2048, 5120), "wo": (5120, 5120),
              "up": (27648, 5120), "gate": (27648, 5120),
              "down": (5120, 27648), "ln": (5120,)}
    grads = {k: (torch.randn(s, generator=g, device="cuda") * 1e-3).to(
        torch.bfloat16) for k, s in shapes.items()}
    err = init_error_buffer(grads)
    mean, new_err = compress_psum(grads, err, ("model",), mesh=mesh)
    for k in sorted(grads):
        parts = [torch.empty_like(grads[k]) for _ in range(world)]
        dist.all_gather(parts, grads[k])
        gf = torch.stack(parts).float()
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127
        q = torch.clamp(torch.round(gf / scale), -128, 127).to(torch.int32)
        want = (q.sum(0).float() * (scale / world)).to(grads[k].dtype)
        want_err = gf[rank] - q[rank].float() * scale
        if not (torch.equal(mean[k], want) and
                torch.equal(new_err[k], want_err)):
            raise AssertionError(f"[dist] compress_psum {k} differs from its "
                                 f"plain arithmetic")
    n = sum(t.numel() for t in grads.values())
    ms = cuda_ms(lambda: compress_psum(grads, err, ("model",), mesh=mesh),
                 iters=5, warmup=1)

    def bf16_mean():
        for t in grads.values():
            dist.all_reduce(t.clone())
    ref_ms = cuda_ms(bf16_mean, iters=5, warmup=1)
    say(f"[dist] compress_psum over {len(grads)} Qwen-width leaves "
        f"({n / 1e6:.1f} M values) on {world} rank(s): equal to the plain "
        f"arithmetic on the gathered gradients; {ms:.3f} ms (event) against "
        f"{ref_ms:.3f} ms for a bf16 all-reduce of the same tree")


def dist_pipeline(world, say):
    """``pipeline_forward`` with stages = ranks at Qwen's d_model (each
    stage tanh(x @ w), w 5120 x 5120 bf16), 8 microbatches of 4 rows,
    against the stages run in turn on one rank (bitwise)."""
    import torch
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((world,), ("stage",), device_type="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    d = 5120
    ws = (torch.randn((world, d, d), generator=g, device="cuda")
          * d ** -0.5).to(torch.bfloat16)
    xs = torch.randn((DIST_MICRO, DIST_BATCH, d), generator=g,
                     device="cuda").to(torch.bfloat16)

    def stage_fn(w, x):
        return torch.tanh(x @ w)
    out = pipeline_forward(stage_fn, ws, xs, mesh, axis="stage")
    want = xs
    for s in range(world):
        want = stage_fn(ws[s], want)
    ms = cuda_ms(lambda: pipeline_forward(stage_fn, ws, xs, mesh,
                                          axis="stage"), iters=5, warmup=1)
    same = torch.equal(out, want)
    say(f"[dist] pipeline_forward, {world} stage(s), {DIST_MICRO} "
        f"microbatches of ({DIST_BATCH}, {d}) bf16: equal to the stages in "
        f"turn {same}; {ms:.3f} ms (event)")
    if not same:
        raise AssertionError("[dist] pipeline_forward differs")


TP_KERNELS = ("qmatmul", "qmatmul_acc", "int_attention_fused",
              "int_decode_attention")


def dist_tp(rank, world, say):
    """[tp]: partitioned serving, each rank holding only its shard of the
    weights and ring caches (``repro_torch.distributed.partition``), on a
    (data 1, model n) mesh under ``Rules(batch=("data",),
    partitioned=True)``.  (a) Qwen2.5-32B and Llama-4-Scout widths at 2
    layers from ``partition.build_params``: ``lm.prefill`` of 4 x 256
    tokens and 16 greedy ring steps, gated by [route] (every linear on
    qmatmul, every row-parallel product on its int32 accumulator output,
    attention on the fused and ring kernels, no plain dispatch), then on
    rank 0 bitwise against the one-rank run of the same tree (logits every
    step, tokens, the gathered ring caches); each also under the
    residual's sequence split (``Rules.seq_tp``, :func:`tp_sp_hold`); (b)
    at four cards, Llama-4-Scout at its 48 layers.  Returns rank 0's
    launches of (a)."""
    import torch
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((1, world), ("data", "model"), device_type="cuda")
    rules = Rules(batch=("data",), mesh=mesh, partitioned=True)
    layout = partition.Layout.of(mesh, ("data",))
    say(f"[tp] {world} rank(s), mesh (data 1, model {world}), "
        f"Rules(batch=('data',), partitioned=True)")
    total = {}
    for arch in ("qwen2.5-32b", "llama4-scout-17b-a16e"):
        cfg = arch_config(arch, "cuda").replace(n_layers=DIST_LAYERS)
        add_launches(total, tp_short(cfg, rules, layout, rank, world, say,
                                     sp=True))
        torch.cuda.empty_cache()
    if world >= 4:
        # ChatGLM3-6B's 2 KV heads over 4 ranks: attention by column, the
        # 8192-slot ring by slot, its decode the staged ring kernel
        cfg = arch_config("chatglm3-6b", "cuda").replace(
            n_layers=DIST_LAYERS)
        add_launches(total, tp_short(cfg, rules, layout, rank, world, say,
                                     max_len=TP_COLUMNS_RING))
        torch.cuda.empty_cache()
    else:
        say(f"[tp] ChatGLM3-6B by column needs four cards (its 2 KV heads "
            f"over 4 model ranks); this run has {world}")
    if world < 4:
        say(f"[tp] (b) Llama-4-Scout at its full depth needs four "
            f"cards; this run has {world}")
    else:
        tp_scout_full(rules, layout, world, say)
    return {k: total.get(k, 0) for k in TP_KERNELS}


def tp_greedy(params, toks, cfg, steps, copies=None, max_len=None):
    """``prefill`` and ``steps`` greedy ring steps (the host clock around
    each, synchronized) of the model that serves ``cfg``: logits (steps +
    1), fed tokens, cache, prefill s, decode s; ``toks``: the prompts, or a
    batch (Whisper's: ``frames`` and ``tokens``); ``max_len`` (default
    DIST_PROMPT + steps) ring slots; ``copies`` collects the cache before
    each step."""
    import torch
    from repro_torch.configs.registry import is_encdec
    from repro_torch.models import encdec, lm
    model = encdec if is_encdec(cfg) else lm
    batch = toks if isinstance(toks, dict) else {"tokens": toks}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lc, cache = model.prefill(params, batch, cfg, max_len or
                              DIST_PROMPT + steps)
    torch.cuda.synchronize()
    t_prefill, step_s = time.perf_counter() - t0, 0.0
    logits, fed = [lc], []
    for _ in range(steps):
        fed.append(torch.argmax(lc[:, 0], -1).to(torch.int32)[:, None])
        if copies is not None:
            copies.append(clone_tree(cache))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lc, cache = model.decode_step(params, fed[-1], cache, cfg)
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t1
        logits.append(lc)
    return logits, fed, cache, t_prefill, step_s


def tp_row_products(cfg):
    """Row-parallel products (each through qmatmul_acc under partitioned
    rules) of a prefill and of a decode step: an LM's wo or RG-LRU w_out
    and its dense or shared down; Whisper's encoder wo and down and its
    decoder's self wo, cross wo and down; none in Mamba (its mixer stays
    whole)."""
    from repro_torch.configs.registry import is_encdec
    if is_encdec(cfg):
        step = 3 * cfg.n_dec_layers
        return 2 * cfg.n_enc_layers + step, step
    if cfg.ssd is not None:
        return 0, 0
    moe = cfg.moe
    n = cfg.n_layers * (1 + int(cfg.d_ff > 0 and (
        moe is None or moe.shared_expert)))
    return n, n


def tp_path(cfg):
    """The kernels a partitioned serving run of ``cfg`` launches (Mamba:
    qmatmul only, no attention and no row-parallel product) and the ring
    layers of its decode step."""
    from repro_torch.configs.registry import is_encdec
    from repro_torch.models import lm
    if is_encdec(cfg):
        return TP_KERNELS, cfg.n_dec_layers
    if cfg.ssd is not None:
        return ("qmatmul",), 0
    return TP_KERNELS, sum(k in lm.ATTN_KINDS for k in lm.block_kinds(cfg))


def tree_bytes(tree):
    from repro_torch import tree as tree_lib
    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree))


def tp_short(cfg, rules, layout, rank, world, say, sp=False, max_len=None):
    """[tp] (a) for one config (``max_len`` ring slots, default the prompt
    and the steps); returns the partitioned runs' launches.  Where
    attention splits by column, a decode step's bytes are held to
    :func:`decode_wire_analytic` on every rank."""
    import torch
    from repro_torch.distributed import partition
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (DIST_BATCH, DIST_PROMPT),
                         generator=g, device="cuda", dtype=torch.int32)
    max_len = max_len or DIST_PROMPT + DIST_STEPS
    cols = partition.split_plan(cfg, layout.m)["heads"] == "columns"
    return tp_hold(cfg, rules, layout, {"tokens": toks}, max_len, DIST_STEPS,
                   f"[tp] {cfg.name} widths, {cfg.n_layers} layers, over "
                   f"{world} rank(s)", rank, world, say, sp=sp,
                   step_wire=decode_wire_analytic(
                       cfg, layout.m, DIST_BATCH, max_len) if cols else None)


def tp_hold(cfg, rules, layout, inputs, max_len, steps, tag, rank, world,
            say, sp=False, step_wire=None):
    """One partitioned serving run of [tp] or [tp-families]: the rank's
    tree from ``partition.build_params`` (seed 0), ``prefill`` of
    ``inputs`` and ``steps`` greedy ring steps under ``rules`` (after a
    cold run), gated by [route] (every int linear on qmatmul, every
    row-parallel product on qmatmul_acc, the fused and ring kernels
    launched, no plain dispatch) and its launch counts; a decode step
    profiled on rank 0; then on rank 0 bitwise against the one-rank run
    of the same tree (logits every step, tokens, every leaf of the
    gathered caches), and every rank's logits and tokens equal to rank
    0's.  With ``sp`` the same run under the residual's sequence split too
    (:func:`tp_sp_hold`), its launches added; with ``step_wire`` (bytes by
    kind) the bytes every rank sends in a decode step held equal to it.
    Returns the partitioned runs' launches."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree as tree_lib
    from repro_torch.configs.registry import is_encdec
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.models import encdec, lm
    model = encdec if is_encdec(cfg) else lm
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    local = partition.build_params(cfg, seed=0, layout=layout)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    with use_rules(rules):
        tp_greedy(local, inputs, cfg, 1, max_len=max_len)  # cold: NCCL
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_stats()
        dispatch.reset_launches()
        col.reset_wire()
        logits, fed, cache, t_prefill, step_s = tp_greedy(
            local, inputs, cfg, steps, max_len=max_len)
        launches = dispatch.launch_counts()
        snap = dispatch.snapshot()
        wire = wire_snapshot()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ran, ring_layers = tp_path(cfg)
    check_route(f"{tag} cuda run", "cuda", launches, snap, ran)
    pre, step = tp_row_products(cfg)
    want = pre + step * steps
    rings = steps * ring_layers
    if snap["qlinear_acc_cuda"] != want or launches["qmatmul_acc"] != want \
            or launches["int_decode_attention"] != rings:
        raise AssertionError(f"{tag}: int32 row products "
                             f"{snap['qlinear_acc_cuda']} (want {want}), "
                             f"ring launches {launches['int_decode_attention']}"
                             f" (want {rings})")
    sp_launches = tp_sp_hold(
        cfg, rules, layout, local, inputs, max_len,
        (logits, fed, cache, wire), snap["qlinear_acc_cuda"], tag,
        say) if sp else {}
    parts = [None] * world
    dist.all_gather_object(parts, (layout, tree_lib.tree_map(
        lambda t: t.cpu(), cache)))
    digests = [None] * world
    dist.all_gather_object(digests, [
        hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()
        for t in logits + fed])
    if any(d != digests[0] for d in digests):
        raise AssertionError(f"{tag}: the ranks' logits or tokens differ")
    # a decode step profiled on rank 0 (the others run the same steps);
    # it writes a copy of the cache
    tok, ring = fed[-1], clone_tree(cache)
    with use_rules(rules):
        run = lambda: model.decode_step(local, tok, ring, cfg)
        col.reset_wire()
        run()                                               # warm
        sent = {k: v for k, v in col.WIRE.items() if v}
        if rank == 0:
            log_profile(f"{tag} decode step", run, 4, step_s / steps * 1e3)
        else:
            for _ in range(4):
                run()
    del ring
    if step_wire is not None:
        want = {k: v for k, v in step_wire.items() if v}
        ok = wire_equal(sent, want)
        say(f"{tag}: a decode step sends {sum(sent.values()) / 1e6:.4f} MB "
            f"({ {k: int(v) for k, v in sent.items()} }), analytic "
            f"{ {k: int(v) for k, v in want.items()} }: equal {ok}")
        if not ok:
            raise AssertionError(f"{tag}: a decode step's bytes {sent} != "
                                 f"{want}")
    b, s = inputs["tokens"].shape
    held = tree_bytes(local)
    whole_bytes = tree_bytes(partition.global_shapes(local, cfg, layout))
    say(f"{tag}: {card_line()}; rank 0 holds {held / 1e9:.3f} GB of "
        f"parameters (the whole tree {whole_bytes / 1e9:.3f} GB; built in "
        f"{t_build:.1f} s); batch {b}, {s}-token prompts, max_len "
        f"{max_len}: prefill {t_prefill * 1e3:.2f} ms, decode step "
        f"{step_s / steps * 1e3:.2f} ms ({b * steps / step_s:.1f} tok/s), "
        f"peak {peak:.2f} GB allocated; int32 row products "
        f"{snap['qlinear_acc_cuda']}; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    del local, cache
    torch.cuda.empty_cache()
    if rank == 0:
        whole = partition.build_params(cfg, seed=0)
        w_logits, w_fed, w_cache, w_pre, w_step = tp_greedy(
            whole, inputs, cfg, steps, max_len=max_len)
        del whole
        got = partition.gather_cache(parts, cfg)
        same_logits = all(torch.equal(x, y) for x, y in zip(logits,
                                                             w_logits))
        same_fed = all(torch.equal(x, y) for x, y in zip(fed, w_fed))
        keys = ["/".join(k) for k, _ in tree_lib.leaves_with_keys(got)]
        differ = [k for k, x, y in zip(keys, tree_lib.leaves(got),
                                       tree_lib.leaves(w_cache))
                  if not torch.equal(x, y.cpu())]
        finite = all(bool(torch.isfinite(x).all()) for x in logits)
        gap = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(logits, w_logits))
        say(f"{tag}: against the one-rank run of the same tree (prefill "
            f"{w_pre * 1e3:.2f} ms, decode step {w_step / steps * 1e3:.2f} "
            f"ms): logits bitwise at every step {same_logits} (max abs "
            f"{gap:.3e}), tokens {same_fed}, gathered caches {not differ} "
            f"({len(keys)} leaves"
            f"{'; differing: ' + ', '.join(differ) if differ else ''}); "
            f"finite {finite}; greedy tokens of row 0 "
            f"{torch.cat(fed, 1)[0].tolist()}")
        if not (same_logits and same_fed and not differ and finite) or \
                tuple(logits[-1].shape) != (b, 1, cfg.vocab):
            raise AssertionError(f"{tag}: partitioned run differs from one "
                                 f"rank")
    add_launches(launches, sp_launches)
    return launches


def tp_sp_hold(cfg, rules, layout, local, inputs, max_len, base, acc, tag,
               say):
    """The run of :func:`tp_hold` again under ``rules`` with ``seq_tp=
    ("model",)``: the residual's sequence split over "model"
    (``partition.seq_split``; m divides the prompt, a decode step keeps it
    whole).  Gated by [route] and the same int32 row products ``acc`` as
    the run without it; on every rank bitwise against that run's ``base``
    (logits every step, fed tokens, every leaf of its cache shard, and the
    bytes it sent); every kernel call at the shape and count of a run
    without the split (``KernelCalls``, a prefill and a step of each); the
    bytes the run sent and its collective result bytes, beside the run
    without it, equal to :func:`sp_run_wire_analytic` (so the split ran),
    and layer 0's alone to :func:`sp_wire_analytic`.  On one model rank
    the split is the identity (``Partition.seq`` is off): printed, and not
    run.  Returns its launches."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels import dispatch
    m = layout.m
    if m == 1:
        say(f"{tag} under seq_tp: on one model rank the residual's "
            f"sequence split is the identity (Partition.seq is off), so "
            f"the run is the one above; not rerun")
        return {}
    sp_rules = dataclasses.replace(rules, seq_tp=("model",))
    steps = len(base[1])
    with use_rules(sp_rules):
        tp_greedy(local, inputs, cfg, 1, max_len=max_len)      # cold
        dispatch.reset_stats()
        dispatch.reset_launches()
        col.reset_wire()
        logits, fed, cache, t_prefill, step_s = tp_greedy(
            local, inputs, cfg, steps, max_len=max_len)
        launches = dispatch.launch_counts()
        snap = dispatch.snapshot()
        wire = wire_snapshot()
    ran, _ = tp_path(cfg)
    check_route(f"{tag} sp cuda run", "cuda", launches, snap, ran)
    calls = {}
    for key, r in (("base", rules), ("sp", sp_rules)):
        with use_rules(r), KernelCalls() as kc:
            tp_greedy(local, inputs, cfg, 1, max_len=max_len)
        calls[key] = kc.shapes()
    b, s = inputs["tokens"].shape
    rows = b // layout.size(("data",)) * s
    run_got = wire_diff(wire, base[3])
    run_want = analytic_flat(*sp_run_wire_analytic(cfg, m, rows))
    flat_a = tree_lib.leaves(cache)
    flat_b = tree_lib.leaves(base[2])
    checks = {
        "int32 row products": snap["qlinear_acc_cuda"] == acc,
        "logits bitwise": all(torch.equal(x, y)
                              for x, y in zip(logits, base[0])),
        "tokens": all(torch.equal(x, y) for x, y in zip(fed, base[1])),
        "cache shard bitwise": len(flat_a) == len(flat_b) and all(
            torch.equal(x, y) for x, y in zip(flat_a, flat_b)),
        "kernel calls as without the split": calls["sp"] == calls["base"],
        "run's bytes as analytic": wire_equal(run_got, run_want),
        "finite": all(bool(torch.isfinite(x).all()) for x in logits)}
    ok = torch.tensor([int(all(checks.values()))], device="cuda")
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    got, want = sp_wire_counts(cfg, rules.mesh, layout, b, s, local=local)
    wire_ok = wire_equal(got, want)
    say(f"{tag} under seq_tp (the residual's sequence split over {m} "
        f"model ranks): {card_line()}; prefill {t_prefill * 1e3:.2f} ms, "
        f"decode step {step_s / steps * 1e3:.2f} ms "
        f"({b * steps / step_s:.1f} tok/s); rank 0's checks {checks}; "
        f"every rank {bool(ok.item())}; kernel calls by shape "
        f"{calls['sp']}; the run's bytes sent and collective result bytes "
        f"beside the run without the split "
        f"{ {k: int(v) for k, v in run_got.items()} }, analytic "
        f"{ {k: int(v) for k, v in run_want.items()} }; layer 0's "
        f"{ {k: int(v) for k, v in got.items()} }, analytic "
        f"{ {k: int(v) for k, v in want.items()} }: equal {wire_ok}; "
        f"launches { {k: n for k, n in launches.items() if n} }")
    if not (ok.item() and wire_ok):
        raise AssertionError(f"{tag}: the run under seq_tp differs from "
                             f"the run without it: {checks}, run bytes "
                             f"{run_got} != {run_want}, layer 0's "
                             f"{got} != {want}")
    return launches


def tp_scout_full(rules, layout, world, say):
    """[tp] (b): Llama-4-Scout at its 48 layers, each rank building its
    shard; its bytes and peak memory against the card's, and the global
    tree's (meta shapes) above it; prefill of 4 x 256 tokens and 16 ring
    steps on the cuda backend, the torch backend teacher-forced beside it
    within the tolerance; a miss only where route flips explain it (as in
    [archs]: the prefill layer by layer, teacher-forced, every layer's
    mixer within the tolerance and its FFN bitwise on the same input, and
    tokens routed differently by either backend's stream)."""
    import torch
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    from repro_torch.configs.registry import get_config
    arch = "llama4-scout-17b-a16e"
    cfg = arch_config(arch, "cuda").replace(
        n_layers=get_config(arch).n_layers)
    tcfg = cfg.replace(quant=cfg.quant.replace(backend="torch"))
    cap = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    local = partition.build_params(cfg, seed=0, layout=layout)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    held = tree_bytes(local)
    build_peak = torch.cuda.max_memory_allocated()
    whole = tree_bytes(partition.global_shapes(local, cfg, layout))
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (DIST_BATCH, DIST_PROMPT),
                         generator=g, device="cuda", dtype=torch.int32)
    with use_rules(rules):
        tp_greedy(local, toks, cfg, 1)     # cold: NCCL, the expert copies
        dispatch.reset_stats()
        dispatch.reset_launches()
        copies = []
        logits, fed, cache, t_prefill, step_s = tp_greedy(
            local, toks, cfg, DIST_STEPS, copies)
        launches = dispatch.launch_counts()
        snap = dispatch.snapshot()
        check_route(f"[tp] (b) llama4-scout {cfg.n_layers} layers cuda run",
                    "cuda", launches, snap, TP_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        gaps = [rel_err(logits[0].float(), tp_greedy(
            local, toks, tcfg, 0)[0][0].float())[1]]
        for i, (tok, c) in enumerate(zip(fed, copies)):
            lf, _ = lm.decode_step(local, tok, c, tcfg)
            gaps.append(rel_err(logits[i + 1].float(), lf.float())[1])
        del copies
        flips = free = 0
        if max(gaps) > LOGITS_RTOL:
            flips, free = layer_attribution(
                "[tp] (b) llama4-scout", local, cfg, tcfg,
                [r.tolist() for r in toks])
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    say(f"[tp] (b) llama4-scout-17b-a16e at {cfg.n_layers} layers over "
        f"{world} ranks: rank 0 holds {held / 1e9:.2f} GB of parameters "
        f"(built in {t_build:.1f} s, peak {build_peak / 1e9:.2f} GB while "
        f"building), the global tree {whole / 1e9:.2f} GB (meta shapes), "
        f"the card {cap / 1e9:.2f} GB; batch {DIST_BATCH}, "
        f"{DIST_PROMPT}-token prompts: prefill {t_prefill * 1e3:.2f} ms, decode step "
        f"{step_s / DIST_STEPS * 1e3:.2f} ms "
        f"({DIST_BATCH * DIST_STEPS / step_s:.1f} tok/s), peak "
        f"{peak / 1e9:.2f} GB allocated; launches "
        f"{ {k: n for k, n in launches.items() if n} }; torch vs cuda "
        f"backend (teacher-forced) max rel {max(gaps):.3e} (tol rel "
        f"{LOGITS_RTOL}; prefill, then each step: "
        f"{' '.join(f'{e:.2e}' for e in gaps)}; route flips {flips} "
        f"teacher-forced, {free} free-running); "
        f"finite {finite}; greedy tokens of row 0 "
        f"{torch.cat(fed, 1)[0].tolist()}")
    if not (held < cap and max(build_peak, peak) < cap < whole):
        raise AssertionError("[tp] (b): a rank's bytes or peak above the "
                             "card, or the global tree within it")
    if (max(gaps) > LOGITS_RTOL and not (flips or free)) or not finite:
        raise AssertionError("[tp] (b): cuda and torch backends differ")


# [tp-shard-bodies]: the reference's two shard bodies on rank-local
# operands under partitioned rules, at [tp]'s shapes: (arch, rules tags);
# "opt" is both options with packed int4 weights (the reference's dry-run
# variant of that name)
SB_RUNS = (("qwen2.5-32b", ("bf16red", "opt")),
           ("llama4-scout-17b-a16e", ("bf16red", "a2a", "opt")),
           ("phi3.5-moe-42b-a6.6b", ("a2a", "opt")))
SB_RULES = {"bf16red": dict(int_bf16_reduce=True), "a2a": dict(moe_a2a=True),
            "opt": dict(int_bf16_reduce=True, moe_a2a=True)}
SB_KERNELS = ("qmatmul", "qmatmul_acc", "int_attention_fused",
              "int_decode_attention")


class A2ACount:
    """Within ``with``: the calls of ``moe.moe_ffn_a2a`` (the all-to-all
    body) in ``n``."""

    def __enter__(self):
        from repro_torch.layers import moe
        self.real, self.n = moe.moe_ffn_a2a, 0

        def counted(*a, **k):
            self.n += 1
            return self.real(*a, **k)
        moe.moe_ffn_a2a = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import moe
        moe.moe_ffn_a2a = self.real


def sb_config(arch, tag, layers=DIST_LAYERS, backend="cuda"):
    cfg = arch_config(arch, backend).replace(n_layers=layers)
    return cfg.replace(quant=cfg.quant.replace(pack_weights=tag == "opt"))


def dist_tp_shard_bodies(rank, world, say):
    """[tp-shard-bodies]: partitioned serving with the reference's
    ``int_bf16_reduce`` (``core/api.py::_int_row_parallel``) and
    ``moe_a2a`` (``layers/moe.py::moe_ffn_a2a``) on each rank's shard, on
    (data 1, model n) and at four cards (data 2, model 2): SB_RUNS at 2
    layers, prefill of 4 x 256 tokens and 16 ring steps, gated by (a)
    bitwise equal to the same bodies on the global tree under the same
    rules on the same mesh, (b) every row-parallel product on qmatmul (none
    on qmatmul_acc) where ``int_bf16_reduce`` is on, every MoE FFN through
    the all-to-all and every local expert on the expert product, (c) the
    torch backend teacher-forced within LOGITS_RTOL (MoE: a miss only
    where route flips explain it), (d) the wire bytes of one row-parallel
    product and one MoE layer, today's partitioned path against the new
    bodies, each equal to its analytic count; at four cards, Llama-4-Scout
    at 48 layers under "opt".  Returns the runs' launches."""
    import torch
    from repro_torch.distributed import partition
    from repro_torch.launch.mesh import make_test_mesh
    shapes = [(1, world)] + ([(2, world // 2)] if world == 4 else [])
    total = {}
    for shape in shapes:
        mesh = make_test_mesh(shape, ("data", "model"), device_type="cuda")
        layout = partition.Layout.of(mesh, ("data",))
        say(f"[tp-shard-bodies] {world} rank(s), mesh (data {shape[0]}, "
            f"model {shape[1]}), Rules(batch=('data',), partitioned=True, "
            f"...): {card_line()}")
        for arch, tags in SB_RUNS:
            for tag in tags:
                add_launches(total, sb_run(sb_config(arch, tag), tag, mesh,
                                           layout, world, say))
                torch.cuda.empty_cache()
        for arch in ("qwen2.5-32b", "llama4-scout-17b-a16e"):
            sb_wire(sb_config(arch, "opt", 1), mesh, layout, say)
            torch.cuda.empty_cache()
    if world < 4:
        say(f"[tp-shard-bodies] Llama-4-Scout at its full depth needs four "
            f"cards; this run has {world}")
    else:
        mesh = make_test_mesh((1, world), ("data", "model"),
                              device_type="cuda")
        sb_scout_full(mesh, partition.Layout.of(mesh, ("data",)), rank,
                      world, say)
    return {k: total.get(k, 0) for k in SB_KERNELS}


def sb_run(cfg, tag, mesh, layout, world, say):
    """One [tp-shard-bodies] run (see :func:`dist_tp_shard_bodies`);
    returns its launches."""
    import torch
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    flags = SB_RULES[tag]
    rules = Rules(batch=("data",), mesh=mesh, partitioned=True, **flags)
    tcfg = cfg.replace(quant=cfg.quant.replace(backend="torch"))
    name = (f"[tp-shard-bodies] {cfg.name} {tag}, {cfg.n_layers} layers, "
            f"mesh {tuple(mesh.shape)}")
    g = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (DIST_BATCH, DIST_PROMPT),
                         generator=g, device="cuda", dtype=torch.int32)
    local = partition.build_params(cfg, seed=0, layout=layout)
    with use_rules(rules):
        tp_greedy(local, toks, cfg, 1)                  # cold: NCCL
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_stats()
        dispatch.reset_launches()
        copies = []
        with A2ACount() as a2a:
            logits, fed, _, t_prefill, step_s = tp_greedy(
                local, toks, cfg, DIST_STEPS, copies)
        launches = dispatch.launch_counts()
        snap = dispatch.snapshot()
        peak = torch.cuda.max_memory_allocated() / 1e9
        # (b) the path: row products, all-to-alls, expert products
        forwards = 1 + DIST_STEPS
        moe = cfg.moe is not None
        ran = ("qmatmul", "int_attention_fused", "int_decode_attention") + \
            (() if flags.get("int_bf16_reduce") else ("qmatmul_acc",))
        check_route(f"{name} cuda run", "cuda", launches, snap, ran)
        pre, step = tp_row_products(cfg)
        rows = pre + step * DIST_STEPS
        bf16 = flags.get("int_bf16_reduce", False)
        a2a_want = cfg.n_layers * forwards if moe and \
            flags.get("moe_a2a") else 0
        experts = 3 * cfg.n_layers * forwards if moe else 0
        bad = []
        if snap["qlinear_row_cuda"] != (rows if bf16 else 0) or \
                snap["qlinear_acc_cuda"] != (0 if bf16 else rows) or \
                (bf16 and launches["qmatmul_acc"]):
            bad.append(f"row products {snap['qlinear_row_cuda']} on qmatmul "
                       f"and {snap['qlinear_acc_cuda']} on qmatmul_acc "
                       f"(want {rows} on "
                       f"{'qmatmul' if bf16 else 'qmatmul_acc'})")
        if a2a.n != a2a_want or snap["qexpert_cuda"] != experts:
            bad.append(f"all-to-all bodies {a2a.n} (want {a2a_want}), expert "
                       f"products {snap['qexpert_cuda']} (want {experts})")
        if bad:
            raise AssertionError(f"{name}: {'; '.join(bad)}")
        # (c) the torch backend, teacher-forced on the cuda run's tokens
        dispatch.reset_stats()
        dispatch.reset_launches()
        gaps = [rel_err(logits[0].float(), tp_greedy(
            local, toks, tcfg, 0)[0][0].float())[1]]
        for i, (tok, c) in enumerate(zip(fed, copies)):
            lf, _ = lm.decode_step(local, tok, c, tcfg)
            gaps.append(rel_err(logits[i + 1].float(), lf.float())[1])
        check_route(f"{name} torch run", "torch", dispatch.launch_counts(),
                    dispatch.snapshot(), ())
        del copies
        flips = free = 0
        if max(gaps) > LOGITS_RTOL and moe:
            flips, free = layer_attribution(name, local, cfg, tcfg,
                                            [r.tolist() for r in toks])
    del local
    torch.cuda.empty_cache()
    # (a) the same bodies on the global tree under the same rules
    whole = partition.build_params(cfg, seed=0)
    with use_rules(Rules(batch=("data",), mesh=mesh, **flags)):
        w_logits, w_fed, *_ = tp_greedy(whole, toks, cfg, DIST_STEPS)
    del whole
    torch.cuda.empty_cache()
    same = all(torch.equal(x, y) for x, y in zip(logits, w_logits)) and \
        all(torch.equal(x, y) for x, y in zip(fed, w_fed))
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    step_ms = step_s / DIST_STEPS * 1e3
    say(f"{name}: prefill {t_prefill * 1e3:.2f} ms, decode step "
        f"{step_ms:.2f} ms ({DIST_BATCH * DIST_STEPS / step_s:.1f} "
        f"tok/s), peak {peak:.2f} GB allocated; row products "
        f"{snap['qlinear_row_cuda']} on qmatmul, {snap['qlinear_acc_cuda']} "
        f"on qmatmul_acc; all-to-all bodies {a2a.n}, expert products "
        f"{snap['qexpert_cuda']}; launches "
        f"{ {k: n for k, n in launches.items() if n} }; (a) bitwise the "
        f"global-tree bodies' logits and tokens: {same}; (c) torch vs cuda "
        f"backend (teacher-forced) max rel {max(gaps):.3e} (tol rel "
        f"{LOGITS_RTOL}; route flips {flips} teacher-forced, {free} "
        f"free-running); finite {finite}; greedy tokens of row 0 "
        f"{torch.cat(fed, 1)[0].tolist()}")
    if not same or not finite or tuple(logits[-1].shape) != (
            DIST_BATCH, 1, cfg.vocab):
        raise AssertionError(f"{name}: the local bodies differ from the "
                             f"global-tree ones")
    if max(gaps) > LOGITS_RTOL and not (flips or free):
        raise AssertionError(f"{name}: cuda and torch backends differ")
    return launches


def wire_analytic(kind, cfg, m, n_dp, rows, seqs=None, split=True):
    """The bytes a rank sends (ring algorithms, as
    ``distributed/collectives.py`` counts them) in one row-parallel
    product (``kind`` "row": x of ``rows`` rows over ``seqs`` sequences,
    N = d_model, K split over "model" when ``split``, else whole on the
    rank: no exchange today, a slice per call in the bf16 body) or one
    MoE FFN (``kind`` "moe": ``rows`` tokens
    a rank) of ``cfg`` (activations in ``cfg.tdtype``), under today's
    partitioned rules ("old") and with both options ("new"), by
    exchange."""
    d, e = cfg.d_model, (cfg.moe.n_experts if cfg.moe else 0)
    es = cfg.tdtype.itemsize
    ar = lambda n, b: 2 * (n - 1) / n * b               # all-reduce
    rs = lambda n, b: (n - 1) / n * b                   # reduce-scatter
    ag = lambda n, b: (n - 1) * b                       # all-gather chunk
    grid = ar(m, 4) + ar(n_dp, 4)     # a per-tensor grid's max (f32)
    # the bf16 body: the f32 partials reduce-scattered, bf16 gathered
    body = {"reduce_scatter": rs(m, rows * d * 4),
            "all_gather": ag(m, rows * d // m * 2)}
    if kind == "row":
        old = {"all_reduce": ar(m, seqs * 4) + ar(m, rows * d * 4)} \
            if split else {}
        return old, body
    k, cf = cfg.moe.top_k, cfg.moe.capacity_factor
    cap = max(int(rows * n_dp * k * cf / e), 1)
    ts = rows // m
    cap_sub = max(int(ts * k * cf / e), 1)
    shared = cfg.moe.shared_expert
    old = {"all_gather": ag(n_dp, rows * d * es)
           + ag(m, e // m * cap * d * es),
           "all_reduce": 3 * ar(m, 4)
           + (3 * grid + ar(m, rows * d * 4) if shared else 0)}
    new = {"all_to_all": 2 * rs(m, e * cap_sub * d * es),
           "all_gather": ag(m, ts * d * es)
           + (body["all_gather"] if shared else 0),
           "all_reduce": ar(m, 4) + ar(n_dp, 4) + (2 * grid if shared else 0),
           "reduce_scatter": body["reduce_scatter"] if shared else 0}
    return old, new


def wire_counts(cfg, mesh, layout, device="cuda"):
    """[tp-shard-bodies] (d): the bytes one rank sends in layer 0's
    row-parallel wo (x (B, S, K/m) of 4 x 256 rows, bf16, the rank's
    rows) and its FFN (MoE when ``cfg`` has experts: the rank's 1024 /
    n_dp tokens), under today's partitioned rules and with both options
    (``collectives.WIRE``), each beside :func:`wire_analytic`'s count:
    {(what, rules): (counted, analytic)}."""
    import torch
    from repro_torch.core.api import dense
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.layers import moe
    m, n_dp = layout.m, layout.size(("data",))
    local = partition.build_params(cfg, seed=0, layout=layout, device=device)
    p0, _ = next(stack_blocks(local, cfg))
    g = torch.Generator(device=device).manual_seed(8)
    b, s = DIST_BATCH // n_dp, DIST_PROMPT
    hq = partition.out_features(p0["attn"]["wq"]) // cfg.hd
    x = torch.randn((b, s, hq * cfg.hd), generator=g, device=device).to(
        cfg.tdtype)
    h = torch.randn((b * s, cfg.d_model), generator=g, device=device).to(
        cfg.tdtype)
    out = {}
    analytic = {"row": wire_analytic("row", cfg, m, n_dp, b * s, b,
                                     hq < cfg.n_heads)}
    if cfg.moe is not None:
        analytic["moe"] = wire_analytic("moe", cfg, m, n_dp, b * s)
    for i, flags in enumerate(({}, SB_RULES["opt"])):
        rules = Rules(batch=("data",), mesh=mesh, partitioned=True, **flags)
        with use_rules(rules), torch.no_grad():
            for what in analytic:
                col.reset_wire()
                if what == "row":
                    dense(x, p0["attn"]["wo"], cfg.quant, tp="row",
                          k_split=hq < cfg.n_heads)
                else:
                    moe.moe_ffn(h, p0["ffn"], cfg.moe, cfg.quant,
                                act=cfg.act)
                got = {k: v for k, v in col.WIRE.items() if v}
                want = {k: v for k, v in analytic[what][i].items() if v}
                out[what, "new" if flags else "old"] = (got, want)
    return out


def sp_splits(cfg, m, kind=None):
    """The row-parallel products with a split K in a layer of ``kind``
    (default layer 0's) of ``cfg`` on ``m`` model ranks
    (``partition.split_plan``): attention's wo (split by head or by
    column), the RG-LRU's w_out, a dense FFN's down (the MoE FFN and the
    SSD mixer come back whole)."""
    from repro_torch.distributed import partition
    from repro_torch.models import lm
    plan = partition.split_plan(cfg, m)
    kind = kind or lm.block_kinds(cfg)[0]
    mixer = plan["heads"] if kind in lm.ATTN_KINDS else \
        plan["rglru"] if kind == "rglru" else False
    return int(bool(mixer)) + int(cfg.d_ff > 0 and cfg.moe is None and
                                  plan["ffn"])


def sp_wire_analytic(cfg, m, rows, kind=None):
    """What the residual's sequence split (``Rules.seq_tp``) changes in
    the bytes a layer of ``kind`` (default layer 0's) of ``cfg`` makes a
    rank send (``collectives.WIRE``, ring algorithms) and in its
    exchanges' result bytes (``RESULT``), by kind: sp minus without, for
    the rank's ``rows`` positions (B x S, m dividing S) on ``m`` model
    ranks.  The normed stream is all-gathered before the mixer and before
    a feed-forward (``cfg.tdtype`` bytes), and each row-parallel product
    with a split K (:func:`sp_splits`) reduce-scatters its 4-byte sums
    (int32, or f32 in the float and fake modes) where it all-reduced
    them.  (wire, result)."""
    d, e = cfg.d_model, cfg.tdtype.itemsize
    # on one model rank nothing is exchanged: the split is the identity
    n, k = (1 + int(cfg.d_ff > 0)) * (m > 1), sp_splits(cfg, m, kind)
    sums = rows * d * 4
    wire = {"all_gather": n * (m - 1) * rows // m * d * e,
            "reduce_scatter": k * (m - 1) / m * sums,
            "all_reduce": -k * 2 * (m - 1) / m * sums}
    result = {"all-gather": n * rows * d * e,
              "reduce-scatter": k * sums // m, "all-reduce": -k * sums}
    return wire, result


def sp_run_wire_analytic(cfg, m, rows):
    """What the split changes in a whole ``lm.forward`` of the rank's
    ``rows`` positions (m dividing S): :func:`sp_wire_analytic` for each
    layer's kind, and the final norm's output all-gathered over "model"
    (``cfg.tdtype`` bytes).  A decode step (S = 1) keeps the residual
    whole, so a greedy run's steps add nothing.  (wire, result)."""
    from repro_torch.models import lm
    d, e = cfg.d_model, cfg.tdtype.itemsize
    last = int(m > 1)
    wire = {"all_gather": last * (m - 1) * rows // m * d * e,
            "reduce_scatter": 0.0, "all_reduce": 0.0}
    result = {"all-gather": last * rows * d * e, "reduce-scatter": 0,
              "all-reduce": 0}
    for kind in lm.block_kinds(cfg):
        w, r = sp_wire_analytic(cfg, m, rows, kind)
        for k in wire:
            wire[k] += w[k]
        for k in result:
            result[k] += r[k]
    return wire, result


def decode_wire_analytic(cfg, m, rows, span):
    """The bytes a rank sends (``collectives.WIRE`` by kind, ring
    algorithms) in one partitioned decode step of ``cfg`` (an LM with
    attention layers and dense feed-forwards, int mode) on (data 1, model
    ``m``), ``rows`` rows, attention split by column (every attention
    layer's ring of ``span`` slots by slot): the vocabulary-split
    embedding's f32 sum; a layer's q, k and v column outputs all-gathered
    (``cfg.tdtype``), its ring's chunk maxima and Sigma partials
    all-gathered and per-block int32 PV all-reduced where each rank's
    slots are whole chunks of the kernel's (``staged_ring_plan``), else its
    codes all-gathered; wo and down each a per-sequence grid's max and
    int32 sums all-reduced; the logits all-gathered along the vocabulary."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import int_attention as ia
    d, hd, kv, es = cfg.d_model, cfg.hd, cfg.kv_heads, cfg.tdtype.itemsize
    g, h = cfg.n_heads // kv, rows * kv
    ar = lambda n: 2 * (m - 1) / m * n                  # all-reduce
    ag = lambda n: (m - 1) * n                          # a rank's chunk
    bk = dispatch.decode_blocks(span, hd)
    plan = ia.staged_ring_plan(g, hd, bk, span, m)
    if plan is not None:
        nloc, nch = span // m // plan[0], span // plan[0]
        nblk = -(-nch // (bk // plan[0]))
        ring_ag, ring_ar = 2 * ag(h * nloc * g * 4), ar(h * nblk * g * hd * 4)
    else:
        dk = hd // 2 if cfg.quant.kv_bits == 4 else hd
        ring_ag, ring_ar = 2 * ag(h * span // m * dk), 0.0
    layer_ag = ag(rows * cfg.n_heads * hd // m * es) + \
        2 * ag(rows * kv * hd // m * es) + ring_ag
    layer_ar = ring_ar + 2 * (ar(rows * 4) + ar(rows * d * 4))
    n = cfg.n_layers
    return {"all_reduce": ar(rows * d * 4) + n * layer_ar,
            "all_gather": n * layer_ag + ag(rows * cfg.vocab // m * es)}


def wire_diff(got, base):
    """{"wire/<kind>", "result/<kind>": got minus base} of two
    :func:`wire_snapshot`'s, the nonzero ones."""
    return {k: got[k] - base[k] for k in got if got[k] != base[k]}


def wire_snapshot():
    """``collectives.WIRE`` and ``RESULT`` as one flat dict."""
    from repro_torch.distributed import collectives as col
    return {**{f"wire/{k}": v for k, v in col.WIRE.items()},
            **{f"result/{k}": v for k, v in col.RESULT.items()}}


def analytic_flat(wire, result):
    """(wire, result) as :func:`wire_snapshot`'s keys, the nonzero ones."""
    out = {**{f"wire/{k}": v for k, v in wire.items()},
           **{f"result/{k}": v for k, v in result.items()}}
    return {k: v for k, v in out.items() if v}


def wire_equal(got, want):
    """Two byte counts by kind equal (to 1e-9 of each: WIRE's shares are
    fractions)."""
    return sorted(got) == sorted(want) and all(
        abs(got[k] - want[k]) <= 1e-9 * max(abs(want[k]), 1) for k in want)


def sp_wire_counts(cfg, mesh, layout, batch, prompt, device="cuda",
                   local=None):
    """Layer 0 of the rank's tree ``local`` (default
    ``partition.build_params``, seed 0) on the rank's rows of ``batch``
    prompts of ``prompt`` positions, under
    partitioned rules without and with ``seq_tp``, its exchanges counted:
    (counted, analytic), each {"wire/<kind>", "result/<kind>": sp minus
    without} (:func:`sp_wire_analytic`)."""
    import torch
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.models import lm
    m, n_dp = layout.m, layout.size(("data",))
    if local is None:
        local = partition.build_params(cfg, seed=0, layout=layout,
                                       device=device)
    p0, kind = next(stack_blocks(local, cfg))
    g = torch.Generator(device=device).manual_seed(9)
    b = batch // n_dp
    x = torch.randn((b, prompt, cfg.d_model), generator=g,
                    device=device).to(cfg.tdtype)
    pos = torch.arange(prompt, dtype=torch.int32,
                       device=device)[None].expand(b, prompt)
    runs = {}
    for sp in (False, True):
        rules = Rules(batch=("data",), mesh=mesh, partitioned=True,
                      seq_tp=("model",) if sp else ())
        with use_rules(rules), torch.no_grad():
            xin = partition.seq_rows(x, sp)
            col.reset_wire()
            lm.apply_block(xin, p0, cfg, kind, positions=pos, seq=sp)
            runs[sp] = wire_snapshot()
    return (wire_diff(runs[True], runs[False]),
            analytic_flat(*sp_wire_analytic(cfg, m, b * prompt)))


def sb_wire(cfg, mesh, layout, say):
    """[tp-shard-bodies] (d) for one config, gated equal to the analytic
    counts (to 1e-9 of each)."""
    res = wire_counts(cfg, mesh, layout)
    for (what, rules), (got, want) in res.items():
        ok = wire_equal(got, want)
        which = "today" if rules == "old" else "both options"
        say(f"[tp-shard-bodies] (d) {cfg.name} layer 0 "
            f"{'wo (row-parallel)' if what == 'row' else 'MoE FFN'}, mesh "
            f"{tuple(mesh.shape)}, {which}: a rank sends "
            f"{sum(got.values()) / 1e6:.4f} MB "
            f"({ {k: int(v) for k, v in got.items()} }), analytic "
            f"{ {k: int(v) for k, v in want.items()} }: equal {ok}")
        if not ok:
            raise AssertionError(f"[tp-shard-bodies] (d) {cfg.name} {what} "
                                 f"{rules}: wire bytes {got} != {want}")


def sb_scout_full(mesh, layout, rank, world, say):
    """[tp-shard-bodies] at four cards: Llama-4-Scout at its 48 layers
    under the "opt" rules on (data 1, model 4): a rank's bytes and peak,
    prefill and ring step times, the route, a decode step's device busy
    share (rank 0's profile), with the card's name and power limit."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    arch = "llama4-scout-17b-a16e"
    cfg = sb_config(arch, "opt", get_config(arch).n_layers)
    rules = Rules(batch=("data",), mesh=mesh, partitioned=True,
                  **SB_RULES["opt"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    local = partition.build_params(cfg, seed=0, layout=layout)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    held = tree_bytes(local)
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (DIST_BATCH, DIST_PROMPT),
                         generator=g, device="cuda", dtype=torch.int32)
    with use_rules(rules):
        tp_greedy(local, toks, cfg, 1)
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_stats()
        dispatch.reset_launches()
        with A2ACount() as a2a:
            logits, fed, cache, t_prefill, step_s = tp_greedy(
                local, toks, cfg, DIST_STEPS)
        launches = dispatch.launch_counts()
        snap = dispatch.snapshot()
        peak = torch.cuda.max_memory_allocated()
        check_route(f"[tp-shard-bodies] {arch} {cfg.n_layers} layers opt",
                    "cuda", launches, snap, ("qmatmul", "int_attention_fused",
                                             "int_decode_attention"))
        tok = fed[-1]
        run = lambda: lm.decode_step(local, tok, clone_tree(cache), cfg)
        run()
        if rank == 0:
            log_profile(f"[tp-shard-bodies] {arch} {cfg.n_layers} layers opt "
                        f"decode step", run, 4, step_s / DIST_STEPS * 1e3)
        else:
            for _ in range(4):
                run()
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    cap = torch.cuda.get_device_properties(0).total_memory
    say(f"[tp-shard-bodies] {arch} at {cfg.n_layers} layers under 'opt' "
        f"(int_bf16_reduce, moe_a2a, packed int4) over {world} ranks, "
        f"{card_line()}: rank 0 holds {held / 1e9:.2f} GB of parameters "
        f"(built in {t_build:.1f} s), peak {peak / 1e9:.2f} GB allocated of "
        f"{cap / 1e9:.2f} GB; batch {DIST_BATCH}, {DIST_PROMPT}-token "
        f"prompts: prefill {t_prefill * 1e3:.2f} ms, decode step "
        f"{step_s / DIST_STEPS * 1e3:.2f} ms "
        f"({DIST_BATCH * DIST_STEPS / step_s:.1f} tok/s); all-to-all bodies "
        f"{a2a.n}, row products on qmatmul {snap['qlinear_row_cuda']}, on "
        f"qmatmul_acc {snap['qlinear_acc_cuda']}; finite {finite}; greedy "
        f"tokens of row 0 {torch.cat(fed, 1)[0].tolist()}")
    if not finite or a2a.n != cfg.n_layers * (1 + DIST_STEPS) or \
            launches["qmatmul_acc"] or not (held < cap and peak < cap):
        raise AssertionError("[tp-shard-bodies] llama4-scout full depth: "
                             "path, finiteness or memory")


# [tp-families]: partitioned ring serving of the recurrent and
# encoder-decoder families on the [dist] ranks, at [recurrent]'s and
# [encdec]'s widths and shapes: (arch, config fields, batch on (data 1,
# model n), batch on (data 2, model n / 2) or None, prompt, max_len)
TF_RUNS = (("recurrentgemma-9b", dict(n_layers=RG_LAYERS), RG_BATCH, 4,
            RG_PROMPT, RG_PROMPT + REC_STEPS),
           ("mamba2-130m", {}, MAMBA_BATCH, 2 * MAMBA_BATCH, MAMBA_PROMPT,
            MAMBA_PROMPT + REC_STEPS),
           ("whisper-large-v3", dict(n_enc_layers=WH_LAYERS,
                                     n_dec_layers=WH_LAYERS),
            WH_BATCH, 2 * WH_BATCH, WH_PROMPT, WH_MAX_LEN))


def dist_tp_families(rank, world, say):
    """[tp-families]: RecurrentGemma-9B (5 layers: the RG-LRU split by
    d_rnn, its one-KV-head local attention whole), Mamba2-130M (the SSD
    mixer whole, rows split) and Whisper-large-v3 (4 + 4 layers, attention
    and caches split by head) served partitioned under
    ``Rules(batch=("data",), partitioned=True)``, each rank holding only
    its shard of the weights, rings and states (``partition.build_params``,
    seed 0): prefill and REC_STEPS greedy ring steps on (data 1, model n)
    and, at four cards, on (data 2, model n / 2) too (RecurrentGemma at
    batch 4, Mamba and Whisper at 8: 4 rows a rank).  First the three
    probes of what a rank's slice would change (``tf_gate_slices``,
    ``tf_norm_rows``, ``tf_ssd_rows``).  Gated by [route] (every int
    linear on qmatmul, every row-parallel product on its int32
    accumulator output, the fused and ring kernels launched, no plain
    dispatch), then on rank 0 bitwise
    against the one-rank run of the same tree (logits every step, tokens,
    the gathered caches with their states); RecurrentGemma's runs also
    under the residual's sequence split (``Rules.seq_tp``,
    :func:`tp_sp_hold`).  Returns rank 0's launches of the partitioned
    runs, summed."""
    import torch
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules
    from repro_torch.launch.mesh import make_test_mesh
    say(f"[tp-families] {world} rank(s); Rules(batch=('data',), "
        f"partitioned=True); {REC_STEPS} greedy ring steps a run")
    tf_gate_slices(rank, say)
    tf_norm_rows(rank, say)
    tf_ssd_rows(rank, say)
    shapes = [(1, world)] + ([(2, world // 2)] if world >= 4 else [])
    total = {}
    for arch, kw, b1, b2, prompt, max_len in TF_RUNS:
        for shape in shapes:
            batch = b1 if shape[0] == 1 else b2
            if batch is None:
                continue
            cfg = family_config(arch, "cuda", **kw)
            mesh = make_test_mesh(shape, ("data", "model"),
                                  device_type="cuda")
            add_launches(total, tp_hold(
                cfg, Rules(batch=("data",), mesh=mesh, partitioned=True),
                partition.Layout.of(mesh, ("data",)),
                tf_batch(cfg, batch, prompt), max_len, REC_STEPS,
                f"[tp-families] {cfg.name} on (data {shape[0]}, model "
                f"{shape[1]})", rank, world, say,
                sp=arch == "recurrentgemma-9b"))
            torch.cuda.empty_cache()
    return {k: total.get(k, 0) for k in TP_KERNELS}


def tf_gate_slices(rank, say):
    """Why a decode step's float RG-LRU gates take ``rglru.gate_step``:
    cuBLAS's product at RecurrentGemma-9B's decode shape against the
    slices a rank holds (contiguous column quarters and halves, and a
    row), and gate_step's; gate_step's time against the matmul's."""
    import torch
    from repro_torch.layers.rglru import gate_step
    if rank != 0:
        return
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((RG_BATCH, 1, 4096), generator=g,
                    device="cuda").to(torch.bfloat16)
    w = (torch.randn((4096, 4096), generator=g, device="cuda") *
         4096 ** -0.5).to(torch.bfloat16)
    cuts = [(slice(None), slice(j * 1024, (j + 1) * 1024)) for j in range(4)]
    cuts += [(slice(r, r + 1), slice(j * 2048, (j + 1) * 2048))
             for r in range(RG_BATCH) for j in range(2)]

    def same(fn):
        whole = fn(x, w)
        return all(torch.equal(whole[rows][..., cols],
                               fn(x[rows], w[:, cols].contiguous()))
                   for rows, cols in cuts)
    mm, gs = torch.matmul(x, w), gate_step(x, w)
    same_mm, same_gs = same(torch.matmul), same(gate_step)
    gap = float((gs.float() - mm.float()).abs().max())
    t_mm = dev_str(device_ms(lambda: torch.matmul(x, w)))
    t_gs = dev_str(device_ms(lambda: gate_step(x, w)))
    say(f"[tp-families] a decode step's float gate, ({RG_BATCH}, 1, 4096) "
        f"x (4096, 4096) bf16, against a rank's slices (column quarters; "
        f"a row with column halves): torch.matmul (cuBLAS) bitwise "
        f"{same_mm}, rglru.gate_step bitwise {same_gs}; gate_step vs "
        f"matmul max abs {gap:.3e}; matmul {t_mm}, gate_step {t_gs} "
        f"({card_line()})")
    if not same_gs:
        raise AssertionError("[tp-families] gate_step depends on its slice")


def tf_norm_rows(rank, say):
    """Why ``layers/norms.py`` pads a few rows to 16 on the card: torch's
    row mean of the first r rows of 64 against the 64 rows' mean, at the
    widths of Whisper-large-v3 (1280), Mamba2-130M's gated norm (1536)
    and RecurrentGemma-9B (4096); and the norms' own."""
    import torch
    from repro_torch.layers import norms
    if rank != 0:
        return
    g = torch.Generator(device="cuda").manual_seed(4)
    plain, ours = [], []
    for d in (1280, 1536, 4096):
        x = torch.randn((64, d), generator=g, device="cuda") * 3 + 1
        gamma = torch.rand((d,), generator=g, device="cuda") + 0.5
        beta = torch.randn((d,), generator=g, device="cuda")
        m = x.mean(-1, keepdim=True)
        ln, rms = norms.layernorm(x, gamma, beta), norms.rmsnorm(x, gamma)
        for r in (1, 2, 3, 4, 8, 15, 16, 32):
            if not torch.equal(x[:r].mean(-1, keepdim=True), m[:r]):
                plain.append(f"d{d}/{r}")
            if not (torch.equal(norms.layernorm(x[:r], gamma, beta), ln[:r])
                    and torch.equal(norms.rmsnorm(x[:r], gamma), rms[:r])):
                ours.append(f"d{d}/{r}")
    say(f"[tp-families] a row's mean among r of 64 rows (r 1, 2, 3, 4, 8, "
        f"15, 16, 32; widths 1280, 1536, 4096, f32): torch's mean differs "
        f"from the 64 rows' at {', '.join(plain) or 'none'}; norms' "
        f"layernorm / rmsnorm at {', '.join(ours) or 'none'}")
    if ours:
        raise AssertionError("[tp-families] a norm depends on the rows")


def tf_ssd_rows(rank, say):
    """Why ``ssd.ssd_step`` sums its products over the state: at
    Mamba2-130M's shapes (8 rows of 512 positions, 24 heads of 64, state
    128, chunks of 128) each of the SSD's einsums over 8 rows against
    its two halves of 4 (a rank's rows at (data 2)), and the port's
    ``ssd_chunked`` and ``ssd_step``."""
    import torch
    from repro_torch.layers import ssd
    if rank != 0:
        return
    g = torch.Generator(device="cuda").manual_seed(5)
    b, s, h, p, n, q = 8, 512, 24, 64, 128, 128
    c = s // q

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    eqs = {"scores": ("bcqhn,bckhn->bchqk", rnd(b, c, q, h, n),
                      rnd(b, c, q, h, n)),
           "y_intra": ("bchqk,bchqk,bckhp->bcqhp", rnd(b, c, h, q, q),
                       rnd(b, c, h, q, q), rnd(b, c, q, h, p)),
           "chunk_state": ("bcqhn,bcqhp,bcqh->bchpn", rnd(b, c, q, h, n),
                           rnd(b, c, q, h, p), rnd(b, c, q, h)),
           "y_inter": ("bcqhn,bchpn,bcqh->bcqhp", rnd(b, c, q, h, n),
                       rnd(b, c, h, p, n), rnd(b, c, q, h)),
           "step y": ("bhn,bhpn->bhp", rnd(b, h, n), rnd(b, h, p, n))}
    halves = (slice(0, b // 2), slice(b // 2, b))
    plain = [name for name, (eq, *ops) in eqs.items()
             if not all(torch.equal(torch.einsum(eq, *ops)[r],
                                    torch.einsum(eq, *(o[r] for o in ops)))
                        for r in halves)]
    x, dt = rnd(b, s, h, p), rnd(b, s, h).abs() * 0.5
    A, B, C = -rnd(h).exp(), rnd(b, s, 1, n), rnd(b, s, 1, n)
    cfg = ssd.SSDConfig(chunk=q)
    whole = ssd.ssd_chunked(x, dt, A, B, C, cfg)
    step = ssd.ssd_step(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], whole[1])
    ours = []
    for r in halves:
        part = ssd.ssd_chunked(x[r], dt[r], A, B[r], C[r], cfg)
        if not all(torch.equal(u[r], v) for u, v in zip(whole, part)):
            ours.append(f"ssd_chunked rows {r.start}:{r.stop}")
        part = ssd.ssd_step(x[r, 0], dt[r, 0], A, B[r, 0], C[r, 0],
                            whole[1][r])
        if not all(torch.equal(u[r], v) for u, v in zip(step, part)):
            ours.append(f"ssd_step rows {r.start}:{r.stop}")
    say(f"[tp-families] the SSD's einsums over {b} rows against their "
        f"halves: torch.einsum differs at {', '.join(plain) or 'none'}; "
        f"ssd_chunked / ssd_step at {', '.join(ours) or 'none'}")
    if ours:
        raise AssertionError("[tp-families] the SSD depends on the rows")


def tf_batch(cfg, batch, prompt):
    """A run's prompts, and Whisper's stub frames, from seed 1 (the same
    on every rank)."""
    import torch
    from repro_torch.configs.registry import is_encdec
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    if is_encdec(cfg):
        out["frames"] = torch.randn((batch, cfg.n_audio_ctx, cfg.d_model),
                                    generator=g, device="cuda")
    out["tokens"] = torch.randint(0, cfg.vocab, (batch, prompt),
                                  generator=g, device="cuda",
                                  dtype=torch.int32)
    return out


# [tp-train]: the reference's train cell (launch/dryrun.py: fake
# w4/a8/attn7, LAMB, ZeRO-1 moments, expert_fsdp; encdec.loss_fn for
# Whisper, lm.lm_loss for the rest) on rank-local trees, at full width,
# bf16, batch 4 x 256 (Whisper's with 1500 stub frames a row, from the
# batch's seed), from partition.build_params's float tree
TT_QUANT = dict(w_bits=4, a_bits=8, attn_bits=7, mode="fake")
TT_STEPS, TT_SERVE = 3, 8
TT_OPT = dict(total_steps=TT_STEPS, warmup_steps=1)
# (a)'s depths: Llama-4-Scout at 2 layers holds 6.47 B parameters, 77.7 GB
# at 12 bytes a parameter (bf16 params and grads, f32 mu / nu); the one-rank
# run (a) is held against must fit one card, so 1 layer (4.27 B, 51.2 GB)
TT_SHORT = (("qwen2.5-32b", 2), ("llama4-scout-17b-a16e", 1))
# (a)'s recurrent and encoder-decoder families: RecurrentGemma-9B at 3
# layers (one (rglru, rglru, local) unit: 2.60 B parameters, 31.2 GB at 12
# bytes), Mamba2-130M whole, Whisper-large-v3 at 4 + 4 layers (its
# "layers" count each stack)
TT_FAMILIES = (("recurrentgemma-9b", 3), ("mamba2-130m", 24),
               ("whisper-large-v3", 4))
# (b), on four cards: Llama-4-Scout at 4 layers and RecurrentGemma-9B at
# all 38 on (data 1, model 4), each more than one card holds with its
# moments
TT_FULL = (("llama4-scout-17b-a16e", 4), ("recurrentgemma-9b", 38))
# (a) past one rank against the one-rank run: the partial products' f32
# sums round bf16 once where one rank rounds each product, so fake-quant
# codes flip at rounding edges and the flips cascade (the reference's own
# sharded Llama-4-Scout SMOKE run is 1.5e-3 from its one-device run in
# f32).  A bf16 param moves only where its update reaches half an ulp, so
# the params are held on the elements that either run moved: the share of
# those equal in both runs, and the gap of the two runs' updates over the
# one-rank update (||d - d_one|| / ||d_one||, over every element).  Each
# limit sits near the geometric mean of the sound runs' worst reading
# and the planted faults' best (``tp_train_faults.py`` on four cards:
# loss 5.5e-4 / 4.9e-2, grad norm 1.3e-3 / 0.26, moved and equal 85% /
# 52%, update gap 0.22 / 0.79; PERF.md, [tp-train])
TT_LOSS_RTOL, TT_GNORM_RTOL = 5e-3, 2e-2
TT_MOVED_EQUAL_MIN, TT_UPDATE_GAP_MAX = 0.7, 0.4
TT_CHUNK = 1 << 26        # elements compared at a time (temporaries' size)


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dist_train(rank, world, say, device="cuda"):
    """[tp-train]: partitioned training, each rank holding only its shard
    of the weights and of the ZeRO-1 moments, under
    ``Rules(batch=("data",), partitioned=True, expert_fsdp=True)``.  (a)
    Qwen2.5-32B (2 layers), Llama-4-Scout (1 layer), RecurrentGemma-9B (3
    layers), Mamba2-130M (24) and Whisper-large-v3 (4 + 4 layers, 1500
    frames) at full width on (data 1, model 1) with one card and (data 2,
    model 2) with four, held on rank 0 against the one-rank run of the
    same tree (:func:`tt_short`); (b) at four cards, Llama-4-Scout at 4
    layers and RecurrentGemma-9B at 38 on (data 1, model 4), more than
    one card holds (:func:`tt_full`).  Each run then integerizes its
    trained tree locally and serves TT_SERVE ring steps partitioned, gated
    by [route].  Returns rank 0's serving launches of (a)."""
    mesh = tt_mesh(world, device)
    say(f"[tp-train] {world} rank(s), mesh (data {mesh.size(0)}, model "
        f"{mesh.size(1)}), Rules(batch=('data',), partitioned=True, "
        f"expert_fsdp=True); fake w4/a8/attn7, LAMB, {TT_STEPS} steps on "
        f"{DIST_BATCH} x {DIST_PROMPT} tokens")
    total = {}
    for arch, layers in TT_SHORT + TT_FAMILIES:
        add_launches(total, tt_short(arch, layers, mesh, rank, world, say,
                                     device))
    if world < 4:
        full = ", ".join(f"{a} at {n} layers" for a, n in TT_FULL)
        say(f"[tp-train] (b) {full} need four cards; this run has {world}")
    else:
        from repro_torch.launch.mesh import make_test_mesh
        full = make_test_mesh((1, world), ("data", "model"),
                              device_type=device)
        for arch, layers in TT_FULL:
            tt_full(arch, layers, full, world, say, device)
    return {k: total.get(k, 0) for k in TP_KERNELS}


def tt_mesh(world, device):
    """(a)'s mesh: (data 2, model world / 2) from four ranks on, else
    (data 1, model world)."""
    from repro_torch.launch.mesh import make_test_mesh
    shape = (2, world // 2) if world >= 4 else (1, world)
    return make_test_mesh(shape, ("data", "model"), device_type=device)


def tt_depth(arch, layers):
    """The config fields of ``layers`` layers (Whisper's: each stack)."""
    from repro_torch.configs.registry import get_config, is_encdec
    if is_encdec(get_config(arch)):
        return dict(n_enc_layers=layers, n_dec_layers=layers)
    return dict(n_layers=layers)


def tt_config(arch, layers):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import QuantConfig
    return get_config(arch).replace(quant=QuantConfig(**TT_QUANT),
                                    **tt_depth(arch, layers))


def tt_batch(cfg, seed, device):
    """Tokens and labels (DIST_BATCH x DIST_PROMPT) from ``seed``, and
    Whisper's stub frames."""
    import torch
    from repro_torch.configs.registry import is_encdec
    g = torch.Generator(device=device).manual_seed(seed)
    out = {k: torch.randint(0, cfg.vocab, (DIST_BATCH, DIST_PROMPT),
                            generator=g, device=device, dtype=torch.int32)
           for k in ("tokens", "labels")}
    if is_encdec(cfg):
        out["frames"] = torch.randn((DIST_BATCH, cfg.n_audio_ctx,
                                     cfg.d_model), generator=g,
                                    device=device)
    return out


def tt_steps(cfg, params, batch, device):
    """TT_STEPS steps of ``make_train_step`` (partitioned under the active
    rules): (params, state, losses, grad norms, host ms a step)."""
    import torch
    from repro_torch.distributed import partition
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state
    state = init_opt_state(params, partition.opt_shards(params, cfg))
    step = make_train_step(cfg, OptConfig(**TT_OPT))
    losses, gnorms, ms = [], [], []
    for _ in range(TT_STEPS):
        sync(device)
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        del met
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()    # Llama's one-card step runs near 80 GB
    return params, state, losses, gnorms, ms


def tt_whole_grads(cfg, params, batch):
    """The gradients of the leaves every rank holds whole (past one rank),
    each rank's flattened (f32, exact for bf16) and gathered: (leaves,
    bitwise equal on every rank)."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import partition
    from repro_torch.launch.train import model_loss, value_and_grad
    if dist.get_world_size() == 1:
        return 0, True
    shards = partition.opt_shards(params, cfg)
    _, _, grads = value_and_grad(model_loss(cfg), params, batch,
                                 shards=shards)
    whole = [g.flatten().float() for g, sh in
             zip(tree_lib.leaves(grads), shards) if not sh.axes]
    del grads
    flat = torch.cat(whole)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return len(whole), all(torch.equal(p, parts[0]) for p in parts)


def tt_compare(cfg, local, start, one, layout, device):
    """Each rank's blocks of the partitioned run's params against the same
    blocks of rank 0's one-rank run (``one``: its final tree on the host;
    None elsewhere), leaf by leaf broadcast from rank 0, summed over every
    rank's blocks: (bitwise, the share of elements that either run moved
    from ``start``, the share of those equal in both runs, the gap of the
    updates ||d - d_one|| / ||d_one||)."""
    import math
    import torch
    import torch.distributed as dist
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import partition
    glob = tree_lib.leaves(partition.global_shapes(local, cfg, layout))
    keyed = tree_lib.leaves_with_keys(local)
    ones = tree_lib.leaves(one) if one is not None else [None] * len(glob)
    same = True
    # elements, moved by either run, moved and equal, |d - d_one|^2,
    # |d_one|^2
    sums = torch.zeros(5, dtype=torch.float64, device=device)
    for (keys, loc), g, o, st in zip(keyed, glob, ones,
                                     tree_lib.leaves(start)):
        full = o.to(device) if o is not None else torch.empty(
            g.shape, dtype=g.dtype, device=device)
        dist.broadcast(full, 0)
        nested = full
        for k in reversed(keys):
            nested = {k: nested}
        blk = tree_lib.leaves(partition.partition_params(nested, cfg,
                                                         layout))[0]
        del full, nested
        same &= torch.equal(loc, blk)
        loc, blk, st = loc.flatten(), blk.flatten(), st.flatten()
        for i in range(0, loc.numel(), TT_CHUNK):
            a, b = loc[i:i + TT_CHUNK].float(), blk[i:i + TT_CHUNK].float()
            s = st[i:i + TT_CHUNK].to(device).float()
            moved = (a != s) | (b != s)
            sums += torch.stack([
                torch.tensor(a.numel(), device=device), moved.sum(),
                (moved & (a == b)).sum(), ((a - b) ** 2).sum(),
                ((b - s) ** 2).sum()]).double()
    flag = torch.tensor([float(not same)], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    dist.all_reduce(sums)
    n, moved, equal, d2, r2 = sums.tolist()
    gap = math.sqrt(d2 / r2) if r2 else (0.0 if d2 == 0 else math.inf)
    return not bool(flag[0]), moved / n, equal / max(moved, 1.0), gap


def tt_serve(cfg_train, arch, layers, params, mesh, world, say, device, tag):
    """The trained tree integerized on the rank (under the training rules)
    and served TT_SERVE ring steps partitioned (Whisper's prompts with
    their frames), gated by [route] (Mamba's on qmatmul only: no
    attention, no row-parallel product) and the counts of row products
    and ring steps; returns the launches."""
    import torch
    from repro_torch.core.api import integerize_params
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.kernels import dispatch
    icfg = family_config(arch, "cuda", **tt_depth(arch, layers))
    with use_rules(Rules(batch=("data",), mesh=mesh, partitioned=True,
                         expert_fsdp=True)), torch.no_grad():
        iq = integerize_params(params, icfg.quant)
    prompt = {k: v for k, v in tt_batch(cfg_train, 9, device).items()
              if k != "labels"}
    with use_rules(Rules(batch=("data",), mesh=mesh, partitioned=True)), \
            torch.no_grad():
        dispatch.reset_stats()
        dispatch.reset_launches()
        logits, fed, _, t_prefill, step_s = tp_greedy(iq, prompt, icfg,
                                                      TT_SERVE)
        launches = dispatch.launch_counts()
        snap = dispatch.snapshot()
    ran, ring_layers = tp_path(icfg)
    check_route(f"[tp-train] {tag} served after training, {world} rank(s)",
                "cuda", launches, snap, ran)
    pre, step = tp_row_products(icfg)
    want = pre + step * TT_SERVE
    rings = TT_SERVE * ring_layers
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    say(f"[tp-train] {tag}: the trained tree integerized on each rank, "
        f"served partitioned: prefill {t_prefill * 1e3:.2f} ms, ring step "
        f"{step_s / TT_SERVE * 1e3:.2f} ms; int32 row products "
        f"{snap['qlinear_acc_cuda']} (want {want}), ring launches "
        f"{launches['int_decode_attention']} (want {rings}); finite "
        f"{finite}; greedy tokens of row 0 {torch.cat(fed, 1)[0].tolist()}")
    if snap["qlinear_acc_cuda"] != want or not finite or \
            launches["int_decode_attention"] != rings:
        raise AssertionError(f"[tp-train] {tag}: serving the trained tree")
    return launches


def tt_one_rank(cfg, batch, device):
    """Rank 0's one-rank run of (a) from ``build_params``'s seed 0: (its
    final tree on the host, losses, grad norms, host ms a step)."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import partition
    whole = partition.build_params(cfg, seed=0, device=device)
    whole, state, loss, gn, ms = tt_steps(cfg, whole, batch, device)
    one = tree_lib.tree_map(lambda t: t.cpu(), whole)
    del whole, state
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return one, loss, gn, ms


def tt_partitioned(cfg, batch, mesh, one, ref, device):
    """The partitioned run of (a) from the same seed, held on rank 0
    against the one-rank run (``one`` its tree, ``ref`` its (losses, grad
    norms); None elsewhere): (local params, moments, readings)."""
    import math
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    cuda = torch.device(device).type == "cuda"
    layout = partition.Layout.of(mesh, ("data",), fsdp=True)
    local = partition.build_params(cfg, seed=0, layout=layout, device=device)
    start = tree_lib.tree_map(lambda t: t.to("cpu", copy=True), local)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with use_rules(Rules(batch=("data",), mesh=mesh, partitioned=True,
                         expert_fsdp=True)):
        n_whole, whole_same = tt_whole_grads(cfg, local, batch)
        local, state, loss, gn, ms = tt_steps(cfg, local, batch, device)
    r = dict(loss=loss, gn=gn, ms=ms, n_whole=n_whole, whole_same=whole_same,
             peak=torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
             held=(tree_bytes(local) + tree_bytes(state)) / 1e9,
             finite=all(math.isfinite(x) for x in loss))
    r["same"], r["moved"], r["moved_equal"], r["update_gap"] = tt_compare(
        cfg, local, start, one, layout, device)
    if ref is not None:
        r["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(loss, ref[0]))
        r["gn_gap"] = max(abs(a - b) / abs(b) for a, b in zip(gn, ref[1]))
    return local, state, r


def tt_gate(r, world):
    """Rank 0's verdict on (a)'s readings against the one-rank run:
    bitwise on one rank, else within the TT_* limits; (ok, the line)."""
    if world == 1:
        ok = r["same"] and r["loss_gap"] == 0 and r["gn_gap"] == 0
        lim = dict(loss=0, gn=0, eq=1, gap=0)
    else:
        ok = (r["loss_gap"] <= TT_LOSS_RTOL and r["gn_gap"] <= TT_GNORM_RTOL
              and r["moved_equal"] >= TT_MOVED_EQUAL_MIN
              and r["update_gap"] <= TT_UPDATE_GAP_MAX)
        lim = dict(loss=TT_LOSS_RTOL, gn=TT_GNORM_RTOL,
                   eq=TT_MOVED_EQUAL_MIN, gap=TT_UPDATE_GAP_MAX)
    return ok, (f"loss max rel {r['loss_gap']:.3e} (tol {lim['loss']}), "
                f"grad norm max rel {r['gn_gap']:.3e} (tol {lim['gn']}); "
                f"params bitwise {r['same']}, {100 * r['moved']:.4f}% of "
                f"elements moved by either run, {100 * r['moved_equal']:.2f}"
                f"% of those equal (min {100 * lim['eq']:.0f}%), update gap "
                f"{r['update_gap']:.4f} (max {lim['gap']})")


def tt_short(arch, layers, mesh, rank, world, say, device):
    """[tp-train] (a) for one config: rank 0's one-rank run, then the
    partitioned run, held against it (:func:`tt_gate`), the whole leaves'
    gradients bitwise on every rank; then the trained tree served."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import Rules, use_rules
    cuda = torch.device(device).type == "cuda"
    cfg = tt_config(arch, layers)
    batch = tt_batch(cfg, 7, device)
    one = ref = None
    if rank == 0:
        one, o_loss, o_gn, o_ms = tt_one_rank(cfg, batch, device)
        ref = (o_loss, o_gn)
    dist.barrier()
    local, state, r = tt_partitioned(cfg, batch, mesh, one, ref, device)
    del one
    say(f"[tp-train] (a) {cfg.name} widths, {layers} layer(s), {world} "
        f"rank(s): rank 0 holds {r['held']:.3f} GB of params and moments; "
        f"{' '.join(f'{t:.1f}' for t in r['ms'])} ms a step (host clock, "
        f"synchronized; the first warms up), peak {r['peak']:.2f} GB "
        f"allocated; losses {' '.join(f'{x:.5f}' for x in r['loss'])}, grad "
        f"norms {' '.join(f'{x:.4f}' for x in r['gn'])}; whole leaves' "
        f"gradients ({r['n_whole']}) bitwise on every rank "
        f"{r['whole_same']}")
    if rank == 0:
        ok, line = tt_gate(r, world)
        say(f"[tp-train] (a) {cfg.name}: against the one-rank run ("
            f"{' '.join(f'{t:.1f}' for t in o_ms)} ms a step; losses "
            f"{' '.join(f'{x:.5f}' for x in o_loss)}, grad norms "
            f"{' '.join(f'{x:.4f}' for x in o_gn)}): {line}")
        if not ok:
            raise AssertionError(f"[tp-train] (a) {cfg.name}: the "
                                 f"partitioned run differs from one rank")
    if not (r["whole_same"] and r["finite"]):
        raise AssertionError(f"[tp-train] (a) {cfg.name}: whole leaves' "
                             f"gradients differ or a loss is not finite")
    rules = Rules(batch=("data",), mesh=mesh, partitioned=True,
                  expert_fsdp=True)
    if cuda:                  # one more step, profiled on rank 0
        with use_rules(rules):
            if rank == 0:
                log_profile(f"[tp-train] (a) {cfg.name} step, {world} "
                            f"rank(s)", lambda: tt_one_step(
                                cfg, local, state, batch), 1, r["ms"][-1])
            else:
                tt_one_step(cfg, local, state, batch)
    del state
    if not cuda:
        return {}
    torch.cuda.empty_cache()
    launches = tt_serve(cfg, arch, layers, local, mesh, world, say, device,
                        f"(a) {cfg.name}")
    del local
    torch.cuda.empty_cache()
    return launches


def tt_one_step(cfg, params, state, batch):
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import OptConfig
    make_train_step(cfg, OptConfig(**TT_OPT))(params, state, batch)


def tt_full(arch, layers, mesh, world, say, device):
    """[tp-train] (b): ``arch`` at ``layers`` layers on (data 1, model
    ``world``): a rank's params and moments, and its peak, within the card
    while the global ones (12 bytes a parameter) are not; the losses
    finite; then the trained tree served."""
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import Rules, use_rules
    import math
    import torch
    import torch.distributed as dist
    from repro_torch import tree as tree_lib
    cfg = tt_config(arch, layers)
    layout = partition.Layout.of(mesh, ("data",), fsdp=True)
    cap = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.reset_peak_memory_stats()
    local = partition.build_params(cfg, seed=0, layout=layout, device=device)
    n_glob = sum(t.numel() for t in tree_lib.leaves(
        partition.global_shapes(local, cfg, layout)))
    batch = tt_batch(cfg, 8, device)
    rules = Rules(batch=("data",), mesh=mesh, partitioned=True,
                  expert_fsdp=True)
    with use_rules(rules):
        local, state, loss, gn, ms = tt_steps(cfg, local, batch, device)
        peak = torch.cuda.max_memory_allocated()
        held = tree_bytes(local) + tree_bytes(state)
        if dist.get_rank() == 0:       # one more step, profiled on rank 0
            log_profile(f"[tp-train] (b) {arch} {layers} layers step, "
                        f"{world} ranks", lambda: tt_one_step(
                            cfg, local, state, batch), 1, ms[-1])
        else:
            tt_one_step(cfg, local, state, batch)
    del state
    torch.cuda.empty_cache()
    finite = all(math.isfinite(x) for x in loss)
    say(f"[tp-train] (b) {arch} at {layers} layers over {world} ranks "
        f"(data 1, model {world}): {n_glob / 1e9:.2f} B parameters, "
        f"{12 * n_glob / 1e9:.1f} GB at 12 bytes a parameter; rank 0 holds "
        f"{held / 1e9:.2f} GB of params and moments, peak "
        f"{peak / 1e9:.2f} GB allocated, the card {cap / 1e9:.2f} GB; "
        f"{' '.join(f'{t:.1f}' for t in ms)} ms a step; losses "
        f"{' '.join(f'{x:.5f}' for x in loss)}, grad norms "
        f"{' '.join(f'{x:.4f}' for x in gn)}")
    if not (finite and peak < cap < 12 * n_glob):
        raise AssertionError(f"[tp-train] (b) {arch}: a loss not finite, a "
                             f"rank's peak above the card, or the global "
                             f"state within it")
    tt_serve(cfg, arch, layers, local, mesh, world, say, device,
             f"(b) {arch} {layers} layers")
    del local
    torch.cuda.empty_cache()


FAULT_GEN = 12
FAULT_LATE = 3            # the step at which requests 3-5 arrive


def fault_script(cfg, params, plan=None, watchdog=None):
    """Six staggered requests (64 to 38 prompt tokens, 12 generated) on 4
    rows and pages of 16, audited after every step.  Requests 0-2 arrive
    first; at step 3 request 3 arrives at priority 1, with 4 and 5 behind
    it.  The pool holds exactly requests 0-3, so a page stolen at step 3
    forces a victim.  Returns the engine and its requests."""
    from repro_torch.launch.engine import PagedEngine, Request
    from repro_torch.launch.serve import staggered_prompts
    prompts = staggered_prompts(6, 64, cfg.vocab)
    pages = [-(-(len(p) + FAULT_GEN) // 16) for p in prompts]
    eng = PagedEngine(cfg, params, batch_size=4, max_len=80, page_size=16,
                      num_pages=sum(pages[:4]), audit_every=1,
                      preempt_after_steps=64, watchdog=watchdog,
                      fault_plan=plan)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=FAULT_GEN,
                    priority=int(i == 3)) for i, p in enumerate(prompts)]
    for r in reqs[:3]:
        eng.submit(r)
    while eng.step_count < FAULT_LATE:
        eng.step()
    for r in reqs[3:]:
        eng.submit(r)
    while eng.step():
        pass
    return eng, reqs


def phase_faults(params):
    """The paged engine's recovery paths through the CUDA kernels at
    Qwen2.5-32B widths: a fault-free run, then drill 1 (a page steal held
    3 steps, two 0.25 s stalls, one NaN row) and drill 2 (two forced
    fallback steps on the plain backend), each against the fault-free
    run."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    from repro_torch.runtime.watchdog import Watchdog
    # no pinned backend: the process default (cuda) runs the kernels and a
    # forced step's use_backend("torch") takes effect
    cfg = model_config(None)
    n_layers = cfg.n_layers

    def run(plan=None, watchdog=None):
        torch.cuda.synchronize()
        dispatch.reset_stats()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with dispatch.use_backend("cuda"):
            eng, reqs = fault_script(cfg, params, plan, watchdog)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out = dict(eng=eng, reqs=reqs, stats=dispatch.snapshot(),
                   launches=dispatch.launch_counts(), s=secs)
        statuses = [r.status for r in reqs]
        log(f"[faults] {'fault-free' if plan is None else plan.summary()}: "
            f"{eng.step_count} steps in {secs:.2f}s, statuses {statuses}, "
            f"preemptions {eng.preempt_count}, resumes {eng.resume_count}, "
            f"quarantined {out['stats']['quarantined']}, forced steps "
            f"{out['stats']['forced_xla_steps']}, watchdog fires "
            f"{out['stats']['watchdog_fires']}, violations "
            f"{eng.violations}; launches {out['launches']}; plain dispatch "
            f"qlinear {out['stats']['qlinear_torch']} paged "
            f"{out['stats']['attention_paged_torch']} prefill "
            f"{out['stats']['attention_torch']}")
        if any(s != "done" for s in statuses) or eng.violations or \
                eng.audit():
            raise AssertionError(f"[faults] statuses {statuses}, "
                                 f"violations {eng.violations}")
        return out

    base = run()
    if base["eng"].preempt_count or base["stats"]["attention_paged_torch"]:
        raise AssertionError("[faults] the fault-free run preempted or ran "
                             "the plain path")

    plan = FaultPlan(at=[FaultEvent(step=FAULT_LATE, steal_pages=3,
                                    steal_hold=3),
                         FaultEvent(step=5, stall_s=0.25),
                         FaultEvent(step=6, stall_s=0.25),
                         FaultEvent(step=9, nan_row=1)])
    d1 = run(plan, Watchdog(threshold=4.0, patience=1))
    eng, st, ln = d1["eng"], d1["stats"], d1["launches"]
    same = [r.tokens == b.tokens for r, b in zip(d1["reqs"], base["reqs"])]
    eng.shutdown()
    while eng._reclaim_one():
        pass
    log(f"[faults] drill 1 (steal, stalls, NaN): tokens bitwise equal to "
        f"the fault-free run {sum(same)}/{len(same)}; after shutdown fault "
        f"holds {eng._fault_held}, free pages {eng.alloc.free_count}/"
        f"{eng.num_pages}")
    plain = st["qlinear_torch"] + st["attention_torch"] + \
        st["attention_paged_torch"]
    if not all(same) or eng.preempt_count < 1 or eng.resume_count < 1 or \
            st["quarantined"] != 1 or st["watchdog_fires"] < 1 or plain or \
            eng._fault_held or eng.alloc.free_count != eng.num_pages or \
            min(ln[k] for k in ("qmatmul", "int_attention_fused",
                                "int_paged_decode_attention")) <= 0:
        raise AssertionError("[faults] drill 1 failed its gates")

    plan = FaultPlan(at=[FaultEvent(step=s, force_xla=True) for s in (4, 8)])
    d2 = run(plan)
    st, ln = d2["stats"], d2["launches"]
    bst, bln = base["stats"], base["launches"]
    agree = sum(int(t == b) for r, rb in zip(d2["reqs"], base["reqs"])
                for t, b in zip(r.tokens, rb.tokens))
    per_dispatch = bln["int_paged_decode_attention"] / \
        bst["attention_paged_cuda"]
    log(f"[faults] drill 2 (two forced steps): greedy tokens equal to the "
        f"fault-free run {agree}/{FAULT_GEN * len(d2['reqs'])} (printed "
        f"only); qmatmul launches {ln['qmatmul']} against "
        f"{bln['qmatmul']}, paged {ln['int_paged_decode_attention']} "
        f"against {bln['int_paged_decode_attention']}")
    # each forced step moves one decode step's linears (q, k, v, o, gate,
    # up, down a layer, then the lm_head) and attention layers to the plain
    # path, and nothing else
    step_q = 7 * n_layers + 1
    if st["forced_xla_steps"] != 2 or st["qlinear_torch"] != 2 * step_q or \
            st["attention_paged_torch"] != 2 * n_layers or \
            st["attention_torch"] or \
            bln["qmatmul"] - ln["qmatmul"] != 2 * step_q or \
            bst["attention_paged_cuda"] - st["attention_paged_cuda"] != \
            2 * n_layers or \
            bln["int_paged_decode_attention"] - \
            ln["int_paged_decode_attention"] != \
            2 * n_layers * per_dispatch:
        raise AssertionError("[faults] drill 2 failed its gates")


def profile_decode(params, cfg, toks, step_ms, steps=4):
    """Where a ring decode step's time goes: torch.profiler over a few
    steps (after the counted run), device kernel time by name.  The busy
    share divides it by ``step_ms``, the step time of the counted run
    with the profiler off (the profiler's own host cost would inflate the
    wall)."""
    import torch
    from repro_torch.models import lm
    lg, cache = lm.prefill(params, {"tokens": toks}, cfg,
                           max_len=RING_MAX_LENS[-1])
    tok = torch.argmax(lg[:, 0], -1).to(torch.int32)[:, None]
    lm.decode_step(params, tok, cache, cfg)                  # warm
    log_profile(f"ring decode step (ring {RING_MAX_LENS[-1]})",
                lambda: lm.decode_step(params, tok, cache, cfg), steps,
                step_ms)


def log_profile(what, fn, calls, ref_ms):
    """torch.profiler over ``calls`` calls of ``fn``: device kernel time
    by name per call, and the busy share against ``ref_ms``, the time of
    one call with the profiler off (the profiler's own host cost would
    inflate the wall)."""
    import torch
    torch.cuda.synchronize()
    wall = []

    def run():
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) / calls * 1e3)

    events, spans = device_trace(run, cpu=True)
    by_name = {}
    for e in events:
        by_name[e.key] = by_name.get(e.key, 0.0) + \
            e.self_device_time_total / 1e3 / calls
    wall = wall[0]
    # busy: the union of the kernels' intervals (NCCL kernels overlap
    # compute on other streams, so a sum would count that time twice)
    busy = union_us(spans) / 1e3 / calls
    if busy <= 0:
        log(f"[profile] {what}: {wall:.2f} ms wall; device time not "
            f"measured (the profiler saw no kernel)")
        return
    nccl = [sp for sp in spans if "nccl" in sp[2].lower()]
    comm = ""
    if nccl:
        n_ms = union_us(nccl) / 1e3 / calls
        c_ms = union_us([sp for sp in spans if "nccl" not in sp[2].lower()]
                        ) / 1e3 / calls
        comm = (f"; NCCL kernels {n_ms:.3f} ms, {n_ms + c_ms - busy:.3f} ms "
                f"of it beside compute kernels")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {what}: device busy {busy:.3f} ms of {ref_ms:.2f} ms "
        f"unprofiled ({100 * busy / ref_ms:.1f}%; the union of the kernels' "
        f"intervals{comm}; {wall:.2f} ms wall with the profiler on); per "
        f"call: " + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))


def layer_at(tree, i):
    """Layer ``i``'s slice of a layer-stacked parameter tree."""
    return {k: (layer_at(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def clone_tree(tree):
    return {k: (clone_tree(v) if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


# [dryrun] (a): one cell of each kind and family on the single mesh, one
# process each on the CPU (arch, shape, variant)
DRYRUN_CELLS = (("qwen2.5-32b", "decode_32k", None),
                ("qwen2.5-32b", "train_4k", None),
                ("llama4-scout-17b-a16e", "train_4k", None),
                ("llama4-scout-17b-a16e", "train_4k", "opt"),
                ("recurrentgemma-9b", "long_500k", None),
                ("whisper-large-v3", "prefill_32k", None),
                ("mamba2-130m", "long_500k", None),
                ("qwen2.5-32b", "train_4k", "sp"))
# [dryrun] (b): rank 0 of these cells run on the card
DRYRUN_CARD = (("qwen2.5-32b", "decode_32k"),
               ("recurrentgemma-9b", "long_500k"))
DRYRUN_JOIN_S = 600
# rank 0's arguments in Qwen2.5-32B x decode_32k x single, forecast from
# the record of the layout before attention split by column (40 191 261
# 956 B): of each of the 64 layers' attention (wq, wk, wv and wo int8
# codes, 62 914 560 B; wq, wk and wv's f32 scales and bf16 biases, 43 008
# B) a rank keeps 1/16, and of the 8 rows' ring (8 KV heads x 32768 slots
# x 128 x 2 int8 codes x 64 layers) 1/16 of the slots
DRYRUN_QWEN_ARGS = (40_191_261_956 - 64 * (62_914_560 + 43_008) * 15 // 16
                    - 8 * 8 * 32768 * 128 * 2 * 64 * 15 // 16)


def phase_dryrun():
    """[dryrun]: (a) ``repro_torch.launch.dryrun`` of DRYRUN_CELLS, rank 0
    of the 16 x 16 mesh on meta tensors under the fake process group, each
    in a process of its own on the CPU, gated at status "ok"; (b) meanwhile,
    rank 0 of DRYRUN_CARD really run on the card (``dryrun_card``), held to
    its dry run: argument bytes exact, the same bytes sent and collective
    result bytes, and every plain dispatch the dry run counted a kernel
    dispatch on the card, each launching its kernel.  Returns (b)'s
    launches."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    d = Path(tempfile.mkdtemp(prefix="dryrun"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = {}
    for i, (arch, shape, variant) in enumerate(DRYRUN_CELLS):
        tag = f"{arch}|{shape}|{variant or 'baseline'}"
        stem = d / f"cell{i}"
        out = open(stem.with_suffix(".log"), "w")
        procs[tag] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out",
             str(stem.with_suffix(".json"))]
            + (["--variant", variant] if variant else []),
            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=ROOT), out,
            stem)
    card = None
    try:
        p = mp.get_context("spawn").Process(target=dryrun_card,
                                            args=(str(d),))
        p.start()
        p.join(DRYRUN_JOIN_S)
        if p.is_alive():
            p.kill()
            p.join()
        if p.exitcode:
            raise AssertionError(f"[dryrun] the card's run exited {p.exitcode}")
        with open(d / "card.json") as f:
            card = json.load(f)
        for proc, _, _ in procs.values():
            proc.wait(timeout=max(1.0, DRYRUN_JOIN_S
                                  - (time.perf_counter() - t0)))
    finally:
        for proc, out, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    recs = {}
    for tag, (proc, _, stem) in procs.items():
        if proc.returncode:
            raise AssertionError(f"[dryrun] {tag} exited {proc.returncode}: "
                                 f"{stem.with_suffix('.log').read_text()[-2000:]}")
        with open(stem.with_suffix(".json")) as f:
            rec, = json.load(f).values()
        recs[tag] = rec
        mem, cost = rec.get("memory", {}), rec.get("cost", {})
        temp = mem.get("temp_size_in_bytes")
        log(f"[dryrun] (a) {tag} x single: {rec['status']} in "
            f"{rec['seconds']} s, rank 0 arguments "
            f"{mem.get('argument_size_in_bytes', 0) / 1e9:.3f} GB, temp "
            + (f"{temp / 1e9:.3f} GB" if temp is not None else
               "not measured (int mode)")
            + f", FLOPs {cost.get('flops', 0):.4g} (unrolled "
            f"{rec.get('cost_unrolled', {}).get('flops', 0):.4g}), collective "
            f"result bytes {rec.get('collectives')}, sent {rec.get('wire')}")
        if rec["status"] != "ok":
            raise AssertionError(f"[dryrun] {tag}: {rec.get('error')}")
    qwen = recs["qwen2.5-32b|decode_32k|baseline"]["memory"][
        "argument_size_in_bytes"]
    log(f"[dryrun] (a) qwen2.5-32b|decode_32k x single: rank 0 arguments "
        f"{qwen} B, forecast {DRYRUN_QWEN_ARGS} B (attention by column, the "
        f"ring by slot): equal {qwen == DRYRUN_QWEN_ARGS}")
    if qwen != DRYRUN_QWEN_ARGS:
        raise AssertionError("[dryrun] (a) Qwen2.5-32B decode_32k's "
                             "arguments differ from the forecast")
    # sp moves activations only: the same arguments, a lower temp
    sp, base = (recs[f"qwen2.5-32b|train_4k|{v}"]["memory"]
                for v in ("sp", "baseline"))
    log(f"[dryrun] (a) qwen2.5-32b|train_4k x single under sp: arguments "
        f"{sp['argument_size_in_bytes']} B (baseline "
        f"{base['argument_size_in_bytes']} B), temp "
        f"{sp['temp_size_in_bytes'] / 1e9:.3f} GB beside the baseline's "
        f"{base['temp_size_in_bytes'] / 1e9:.3f} GB")
    if sp["argument_size_in_bytes"] != base["argument_size_in_bytes"]:
        raise AssertionError("[dryrun] (a) the sp cell's arguments differ "
                             "from the baseline cell's")
    total = {name: 0 for name in KERNELS}
    for arch, shape in DRYRUN_CARD:
        add_launches(total, dryrun_hold(arch, shape, card[f"{arch}|{shape}"],
                                        recs[f"{arch}|{shape}|baseline"]))
    log(f"[dryrun] phase {time.perf_counter() - t0:.1f} s; the card's "
        f"launches {total}")
    return total


def dryrun_card(d):
    """[dryrun] (b) in a process of its own: rank 0 of each DRYRUN_CARD
    cell at full width and depth, on the card, under the fake process
    group of the 16 x 16 mesh (``device_type="cuda"``), its tree from
    ``partition.build_params(layout=rank 0)``, the ring's positions as
    after all but one of its slots, on the ``cuda`` backend; what
    ``dryrun.measure`` counts, the peak memory and the shape of every
    kernel call dispatch makes (``KernelCalls``), to ``d``/card.json."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    for arch, shape in DRYRUN_CARD:
        with dryrun.fake_group(dryrun.MESHES["single"]):
            mesh = make_production_mesh(device_type="cuda")
            t = time.perf_counter()
            cell = dryrun._make_cell(arch, shape, mesh, device="cuda")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            with KernelCalls() as calls:
                rec, got = dryrun.measure(cell, backend="cuda", memory=False)
            torch.cuda.synchronize()
            rec.update(step_s=time.perf_counter() - t, build_s=build_s,
                       held_bytes=held,
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       logits_shape=list(got[0].shape),
                       calls=calls.shapes())
            del cell, got
            torch.cuda.empty_cache()
        out[f"{arch}|{shape}"] = rec
    with open(os.path.join(d, "card.json"), "w") as f:
        json.dump(out, f)


class KernelCalls:
    """Inside the block, the shape of each call dispatch makes of qmatmul
    (M, N, K, packed), qmatmul_acc (the same) and the ring kernel
    (kv_bits, span, pos, window, G, D, head-folds; staged over a ring split
    by slot range, the ranks too), in ``dispatch``'s namespace: what the
    wrappers launch, left as it is."""

    def __enter__(self):
        from repro_torch.kernels import dispatch
        self.dispatch, self.calls = dispatch, []
        self.orig = {n: getattr(dispatch, n) for n in
                     ("qmatmul", "qmatmul_acc", "int_decode_attention",
                      "int_decode_attention_staged")}

        def matmul(name):
            def call(x, w, *args, packed=False, **kw):
                self.calls.append((name, (x.shape[0], w.shape[0],
                                          x.shape[1], packed)))
                return self.orig[name](x, w, *args, packed=packed, **kw)
            return call

        def ring(q, k, v, sc, vs, kpos, pos, *, window=None, packed=False,
                 **kw):
            self.calls.append(("int_decode_attention", (
                4 if packed else 8, k.shape[1],
                pos.clone() if hasattr(pos, "clone") else pos, window,
                q.shape[1], q.shape[2], q.shape[0])))
            return self.orig["int_decode_attention"](
                q, k, v, sc, vs, kpos, pos, window=window, packed=packed,
                **kw)

        def staged(q, k, v, sc, vs, kpos, pos, *, parts, window=None,
                   packed=False, **kw):
            self.calls.append(("int_decode_attention", (
                4 if packed else 8, k.shape[1] * parts,
                pos.clone() if hasattr(pos, "clone") else pos, window,
                q.shape[1], q.shape[2], q.shape[0], parts)))
            return self.orig["int_decode_attention_staged"](
                q, k, v, sc, vs, kpos, pos, parts=parts, window=window,
                packed=packed, **kw)

        dispatch.qmatmul, dispatch.qmatmul_acc = (matmul("qmatmul"),
                                                  matmul("qmatmul_acc"))
        dispatch.int_decode_attention = ring
        dispatch.int_decode_attention_staged = staged
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dispatch, name, fn)
        return False

    def shapes(self):
        """{kernel: [[shape, calls], ...]}, the ring's pos read back."""
        out = {}
        for name, shape in self.calls:
            shape = tuple(int(x) if hasattr(x, "item") else x
                          for x in shape)
            out.setdefault(name, {}).setdefault(shape, 0)
            out[name][shape] += 1
        return {k: [[list(s), n] for s, n in v.items()]
                for k, v in out.items()}


def dryrun_hold(arch, shape, card, rec):
    """Gate [dryrun] (b)'s run of one cell against its dry run ``rec``
    and the check phase's rows; returns the kernels' launches."""
    tag = f"{arch} x {shape} x single"
    args = rec["memory"]["argument_size_in_bytes"]
    log(f"[dryrun] (b) {tag} on the card: rank 0's tree built in "
        f"{card['build_s']:.1f} s, step {card['step_s']:.3f} s (first call); "
        f"arguments {card['memory']['argument_size_in_bytes']} B (dry run "
        f"{args} B); peak max_memory_allocated {card['peak_bytes'] / 1e9:.3f}"
        f" GB ({card['held_bytes'] / 1e9:.3f} GB held before the step) "
        f"beside the dry run's forecast of the arguments, {args / 1e9:.3f} "
        f"GB (temp not forecast: {rec['memory'].get('temp_not_measured')}); "
        f"logits {card['logits_shape']}")
    plain = {k: v for k, v in rec["launches"].items() if k.endswith("_torch")}
    want = {k[:-len("_torch")] + "_cuda": v for k, v in plain.items()}
    got, launches = card["launches"], card["kernel_launches"]
    calls = {k: {tuple(s): n for s, n in v}
             for k, v in card["calls"].items()}
    n_calls = {k: sum(v.values()) for k, v in calls.items()}
    checked = {"qmatmul": {row[:4] for row in QMM_CHECKS}
               | {row[:4] for row in QMM_SHARD},
               "qmatmul_acc": set(QMM_ACC),
               "int_decode_attention": set(RING_DRYRUN) | set(RING_SPLIT)}
    unchecked = {k: sorted(set(v) - checked[k]) for k, v in calls.items()
                 if set(v) - checked[k]}
    log(f"[dryrun] (b) {tag}: dispatches {got} (dry run {rec['launches']}); "
        f"kernel launches {launches}; kernel calls by shape {calls}; sent "
        f"{card['wire']} (dry run {rec['wire']}); collective result bytes "
        f"{card['collectives']} (dry run {rec['collectives']})")
    checks = {
        "argument bytes": card["memory"]["argument_size_in_bytes"] == args,
        "held on the card": card["held_bytes"] >= args,
        "bytes sent": card["wire"] == rec["wire"],
        "collective result bytes": card["collectives"] == rec["collectives"],
        "dispatches": got == want and bool(want),
        "each kernel launched": all(launches.get(k, 0) > 0 for k in (
            "qmatmul", "qmatmul_acc", "int_decode_attention")),
        # qmatmul_acc's wrapper counts its launch under qmatmul too
        "a launch each call": launches == {
            "qmatmul": n_calls.get("qmatmul", 0)
            + n_calls.get("qmatmul_acc", 0),
            "qmatmul_acc": n_calls.get("qmatmul_acc", 0),
            "int_decode_attention": n_calls.get("int_decode_attention", 0)},
        "every shape checked": not unchecked}
    if not all(checks.values()):
        raise AssertionError(f"[dryrun] (b) {tag}: {checks}; shapes no "
                             f"check row holds: {unchecked}")
    return launches


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


VIT_BATCH = 64


def vit_config(backend, w_bits=4, attn_bits=7):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import QuantConfig
    qc = QuantConfig(w_bits=w_bits, a_bits=8, attn_bits=attn_bits,
                     mode="int", backend=backend)
    return get_config("deit-s").replace(quant=qc)


def phase_vit():
    """DeiT-S at full width on the cuda backend; the torch backend on the
    same inputs beside it."""
    import torch
    from repro_torch.core.api import integerize_params
    from repro_torch.kernels import dispatch
    from repro_torch.models import vit
    cfg, tcfg = vit_config("cuda"), vit_config("torch")
    log(f"[vit] DeiT-S: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, {cfg.img_size} px / patch "
        f"{cfg.patch} ({cfg.n_tokens} tokens), batch {VIT_BATCH}, "
        f"w4/a8/attn7, {cfg.dtype}, random weights from seed 0")
    params = integerize_params(vit.init_params(cfg, seed=0, device="cuda"),
                               cfg.quant)
    g = torch.Generator(device="cuda").manual_seed(2)
    imgs = torch.randn((VIT_BATCH, cfg.img_size, cfg.img_size,
                        cfg.channels), generator=g, device="cuda")
    torch.cuda.synchronize()
    dispatch.reset_stats()
    dispatch.reset_launches()
    logits = vit.forward(params, imgs, cfg)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    snap = dispatch.snapshot()
    tlogits = vit.forward(params, imgs, tcfg)
    abs_e, rel_e = rel_err(logits, tlogits)
    agree = int((logits.argmax(-1) == tlogits.argmax(-1)).sum())
    ms = cuda_ms(lambda: vit.forward(params, imgs, cfg), iters=10, warmup=2)
    log(f"[vit] launches {launches}; dispatch qlinear cuda "
        f"{snap['qlinear_cuda']} torch {snap['qlinear_torch']}, attention "
        f"cuda {snap['attention_cuda']} torch {snap['attention_torch']}; "
        f"blocks {snap['blocks']}")
    log(f"[vit] logits cuda vs torch backend: max abs {abs_e:.3e} rel "
        f"{rel_e:.3e} (tol rel {LOGITS_RTOL}); argmax equal {agree}/"
        f"{VIT_BATCH} (printed only); finite "
        f"{bool(torch.isfinite(logits).all())}")
    log(f"[vit] forward {ms:.3f} ms per batch of {VIT_BATCH} "
        f"({VIT_BATCH / ms * 1e3:.1f} images/s; CUDA events, after warm-up)")
    log_profile(f"DeiT-S forward (batch {VIT_BATCH})",
                lambda: vit.forward(params, imgs, cfg), 2, ms)
    want_q = 1 + 6 * cfg.n_layers
    if launches["qmatmul"] != want_q or \
            launches["int_attention_fused"] != cfg.n_layers:
        raise AssertionError(f"DeiT-S launches {launches}, expected "
                             f"{want_q} qmatmul and {cfg.n_layers} fused")
    if snap["qlinear_torch"] or snap["attention_torch"]:
        raise AssertionError(f"plain-path dispatches on the cuda run: {snap}")
    if tuple(logits.shape) != (VIT_BATCH, cfg.n_classes) or \
            not bool(torch.isfinite(logits).all()) or rel_e > LOGITS_RTOL:
        raise AssertionError("DeiT-S logits: cuda and torch differ")
    return params, imgs


# Table II's "Ours 3-bit" and "Ours 2-bit" (benchmarks/table2_comparison.py):
# (w_bits, attn_bits), 8-bit activations
LOWBIT_VIT = ((3, 3), (2, 2))
# benchmarks/fig_softmax_error.py's prob grid sweep
EQ4_BITS = (2, 3, 4, 7)


def phase_lowbit(imgs):
    """DeiT-S at the paper's 3- and 2-bit points on the cuda backend, with
    the torch backend beside it teacher-forced layer by layer (each layer
    on the cuda run's residual stream; the ring phase's method) and
    free-running; then Eq. 4's attention error against the prob grid's
    bits, through the fused kernel."""
    import torch
    from repro_torch.core.api import integerize_params
    from repro_torch.kernels import dispatch
    from repro_torch.models import vit
    fparams = vit.init_params(vit_config("cuda"), seed=0, device="cuda")
    for w_bits, attn_bits in LOWBIT_VIT:
        cfg = vit_config("cuda", w_bits, attn_bits)
        tcfg = vit_config("torch", w_bits, attn_bits)
        params = integerize_params(fparams, cfg.quant)
        torch.cuda.synchronize()
        dispatch.reset_stats()
        dispatch.reset_launches()
        logits = vit.forward(params, imgs, cfg)
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()
        snap = dispatch.snapshot()
        tlogits = vit.forward(params, imgs, tcfg)
        free_abs, free_rel = rel_err(logits, tlogits)
        agree = int((logits.argmax(-1) == tlogits.argmax(-1)).sum())
        # layer by layer: x is the cuda run's residual stream, xt the torch
        # backend's own; each layer's update (its output less its input)
        # compared on the same input, and the streams compared free-running
        x = vit.embed(params, imgs, cfg)
        xt = vit.embed(params, imgs, tcfg)
        forced, free = [], []
        for i in range(cfg.n_layers):
            p = layer_at(params["layers"], i)
            y, yf = vit.block(x, p, cfg), vit.block(x, p, tcfg)
            forced.append(rel_err(yf - x, y - x)[1])
            xt = vit.block(xt, p, tcfg)
            free.append(rel_err(xt, y)[1])
            x = y
        same = torch.equal(vit.head(params, x, cfg), logits)
        f_abs, f_rel = rel_err(vit.head(params, yf, tcfg), logits)
        finite = bool(torch.isfinite(logits).all())
        log(f"[lowbit] DeiT-S w{w_bits}/a8/attn{attn_bits}, batch "
            f"{imgs.shape[0]}, random weights from seed 0: launches qmatmul "
            f"{launches['qmatmul']} fused {launches['int_attention_fused']}; "
            f"dispatch qlinear torch {snap['qlinear_torch']}, attention "
            f"torch {snap['attention_torch']}; finite {finite}; layer by "
            f"layer equal to the forward {same}")
        log(f"[lowbit] w{w_bits}/attn{attn_bits} torch vs cuda backend, "
            f"teacher-forced: logits max abs {f_abs:.3e} rel {f_rel:.3e}, "
            f"each layer's update max rel "
            f"{' '.join(f'{e:.2e}' for e in forced)} (tol rel "
            f"{LOGITS_RTOL})")
        log(f"[lowbit] w{w_bits}/attn{attn_bits} torch vs cuda backend, "
            f"free-running (printed only): logits max abs {free_abs:.3e} rel "
            f"{free_rel:.3e}, argmax equal {agree}/{imgs.shape[0]}; residual "
            f"stream after each layer max rel "
            f"{' '.join(f'{e:.2e}' for e in free)}")
        want_q = 1 + 6 * cfg.n_layers
        if launches["qmatmul"] != want_q or \
                launches["int_attention_fused"] != cfg.n_layers:
            raise AssertionError(f"[lowbit] launches {launches}, expected "
                                 f"{want_q} qmatmul, {cfg.n_layers} fused")
        if snap["qlinear_torch"] or snap["attention_torch"]:
            raise AssertionError(f"[lowbit] plain dispatches: {snap}")
        if not finite or not same or f_rel > LOGITS_RTOL or \
                max(forced) > LOGITS_RTOL:
            raise AssertionError(f"[lowbit] w{w_bits}/attn{attn_bits}: cuda "
                                 f"and torch differ on the same inputs")
        del params, x, xt, y, yf
    del fparams
    eq4_sweep()


def eq4_sweep():
    """``benchmarks/fig_softmax_error.py``'s attention (1 x 4 heads x 64
    tokens x 32, causal, float inputs from numpy seed 0) through the port's
    ``layers.attention.attention`` at each prob grid: the output's max abs
    error against the float path over the float output's max.  The kernel
    route must take the fused kernel; the error must not grow with bits
    (``tests/test_paper_tables.py::test_eq4_error_bound``)."""
    import numpy as np
    import torch
    from repro_torch.core.api import QuantConfig
    from repro_torch.kernels import dispatch
    from repro_torch.layers.attention import AttnSpec, attention
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 4, 64, 32).astype(np.float32))
               .to("cuda") for _ in range(3))
    spec = AttnSpec(q_chunk=64)
    ref = attention(q, k, v, spec)
    scale = ref.abs().max().item()
    errs, plain = [], []
    for bits in EQ4_BITS:
        qc = QuantConfig(w_bits=8, a_bits=8, attn_bits=bits, mode="int",
                         backend="cuda")
        dispatch.reset_stats()
        dispatch.reset_launches()
        out = attention(q, k, v, spec, qc)
        torch.cuda.synchronize()
        fused = dispatch.launch_counts()["int_attention_fused"]
        snap = dispatch.snapshot()
        errs.append((out - ref).abs().max().item() / scale)
        tout = attention(q, k, v, spec, qc.replace(backend="torch"))
        plain.append((tout - ref).abs().max().item() / scale)
        if fused != 1 or snap["attention_cuda"] != 1 or \
                snap["attention_torch"]:
            raise AssertionError(f"[lowbit] Eq. 4 at {bits} bits: fused "
                                 f"launches {fused}, dispatch {snap}")
    log(f"[lowbit] Eq. 4 attention output error against the float path, "
        f"prob bits {EQ4_BITS}: fused kernel {[f'{e:.6f}' for e in errs]}; "
        f"plain path {[f'{e:.6f}' for e in plain]} (printed only)")
    if errs != sorted(errs, reverse=True):
        raise AssertionError(f"[lowbit] Eq. 4 error grows with bits: {errs}")


def phase_ops(params, imgs):
    """The paper's integerized self-attention module through the kernel
    entry points, on layer 0 of DeiT-S and the model's residual stream."""
    import torch
    from repro_torch.core import quant
    from repro_torch.core.integerize import QLinearParams
    from repro_torch.core.softmax2 import LOG2E
    from repro_torch.kernels import dispatch, ops, ref
    from repro_torch.kernels import int_attention as ia
    from repro_torch.layers.norms import layernorm
    from repro_torch.models import vit
    cfg = vit_config("cuda")
    lay = layer_at(params["layers"], 0)
    b, heads, hd = imgs.shape[0], cfg.n_heads, cfg.hd
    x = vit.embed(params, imgs, cfg)
    x = x.reshape(-1, cfg.d_model).contiguous()          # (64 * 198, 384)
    ln = lay["ln1"]
    delta = float(quant.absmax_scale(layernorm(x, ln["gamma"], ln["beta"]),
                                     8))
    torch.cuda.synchronize()
    dispatch.reset_launches()
    codes = ops.pq_layernorm_op(x, ln["gamma"], ln["beta"], delta, bits=8)
    torch.cuda.synchronize()
    want = ref.pq_layernorm_ref(x, ln["gamma"], ln["beta"], delta, bits=8)
    pq_diff = int((codes.int() - want.int()).abs().max())
    log(f"[ops] pq_layernorm_op rows={x.shape[0]} d={x.shape[1]} delta "
        f"{delta:.4e} (8-bit, from the float LayerNorm): codes "
        f"{'exact' if pq_diff == 0 else f'MISMATCH (max step {pq_diff})'} "
        f"against the plain version")
    if pq_diff:
        raise AssertionError("[ops] pq_layernorm differs")
    xq = quant.QTensor(codes, torch.tensor(delta, device="cuda"), 8)

    def lin(name, a):
        p = lay["attn"][name]
        y = ops.qlinear_op(a, QLinearParams(p["w_q"], p["w_scale"], p["b"]))
        torch.cuda.synchronize()
        want = ref.qmatmul_ref(a.q, p["w_q"], (p["w_scale"] * a.scale)
                               .to(torch.float32), p["b"].to(torch.float32))
        if not torch.equal(y, want):
            raise AssertionError(f"[ops] qlinear_op {name} differs")
        return y

    def fold(y):                          # (B*N, d) -> (B*H, N, hd) codes
        y = y.reshape(b, -1, heads, hd).permute(0, 2, 1, 3)
        return quant.quantize_tensor(y.reshape(b * heads, -1, hd)
                                     .contiguous(), 8)

    qq, kq, vq = (fold(lin(n, xq)) for n in ("wq", "wk", "wv"))
    kw = dict(softmax_scale=hd ** -0.5, attn_bits=7, causal=False,
              return_codes=True)
    att = {f: ops.int_attention_op(qq, kq, vq, fused=f, **kw)
           for f in (True, False)}
    torch.cuda.synchronize()
    sc = hd ** -0.5 * qq.scale * kq.scale * LOG2E
    want, wcodes = ia.int_attention_plain(qq.q, kq.q, vq.q, sc, vq.scale,
                                          attn_bits=7, causal=False, bq=128,
                                          bk=128, return_codes=True)
    errs = {}
    for f, (out, c) in att.items():
        abs_e, rel_e = rel_err(out, want)
        errs[f] = abs_e
        ok = torch.equal(c, wcodes) and rel_e <= ATTN_RTOL
        log(f"[ops] int_attention_op fused={f} H={qq.q.shape[0]} "
            f"S={qq.q.shape[1]} D={hd} bq=bk=128: codes "
            f"{'exact' if torch.equal(c, wcodes) else 'MISMATCH'}, out max "
            f"abs {abs_e:.3e} rel {rel_e:.3e} (tol rel {ATTN_RTOL})")
        if not ok:
            raise AssertionError("[ops] int_attention_op differs")
    f_abs, f_rel = rel_err(att[False][0], att[True][0])
    log(f"[ops] two-pass vs fused: max abs {f_abs:.3e} rel {f_rel:.3e} "
        f"(bitwise equal: {torch.equal(att[False][0], att[True][0])})")
    if f_rel > ATTN_RTOL:
        raise AssertionError("[ops] two-pass and fused differ")
    o = att[True][0].reshape(b, heads, -1, hd).permute(0, 2, 1, 3)
    out = lin("wo", quant.quantize_tensor(o.reshape(x.shape[0], -1)
                                          .contiguous(), 8))
    launches = dispatch.launch_counts()
    log(f"[ops] out {tuple(out.shape)} finite "
        f"{bool(torch.isfinite(out).all())}; launches {launches}")
    if launches["pq_layernorm"] != 1 or launches["int_attention"] != 1 or \
            launches["int_attention_fused"] != 1 or \
            launches["qmatmul"] != 4 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[ops] launches {launches}")
    return launches, {"int_attention": errs[False],
                      "int_attention_fused": errs[True],
                      "pq_layernorm": float(pq_diff)}


# ---------------------------------------------------------------------------
# [train]: QAT training on the card
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_HEAD_STEPS = 60, 10       # the recipe: head only, then all
TRAIN_BATCH = 64
TRAIN_CPU_BATCH = 8
# card vs cpu, one step at full DeiT-S size: f32 sums in other orders
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-4, 1e-3
# the same with every fake-quant value replayed from the CPU's run: f32 sums
# in other orders alone
TRAIN_REPLAY_RTOL = 1e-4
# past TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL, the free-running step's bounds
# while code flips explain its gap (an H100 read 4.991e-4 / 1.236e-3)
TRAIN_FREE_LOSS_RTOL, TRAIN_FREE_GNORM_RTOL = 5e-3, 1e-2
TRAIN_LM_LAYERS, TRAIN_LM_BATCH, TRAIN_LM_SEQ = 2, 2, 512
RESTART_STEPS, RESTART_STOP, RESTART_EVERY = 30, 20, 10


def train_vit_config():
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import QuantConfig
    return get_config("deit-s").replace(quant=QuantConfig(
        w_bits=4, a_bits=8, attn_bits=7, mode="fake"))


def train_recipe_opt():
    from repro_torch.optim import OptConfig
    return OptConfig(kind="lamb", lr=5e-4, weight_decay=0.0,      # §V-A
                     warmup_steps=10, total_steps=TRAIN_STEPS)


def frozen_but(before, after, keep):
    """Leaves other than those whose path holds ``keep`` that moved."""
    import torch
    from repro_torch import tree as tree_lib
    old = dict(tree_lib.leaves_with_paths(before))
    return [p for p, leaf in tree_lib.leaves_with_paths(after)
            if keep not in p and not torch.equal(leaf, old[p])]


def timed(fn):
    """(fn's result, its CUDA-event ms)."""
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def train_deit(card):
    """The paper's recipe at DeiT-S's full size: head-only LAMB steps, then
    full QAT steps, then integerization and the int forward on the
    kernels."""
    import math
    import torch
    from repro_torch.core.api import integerize_params
    from repro_torch.data.synthetic import image_batch
    from repro_torch.examples.train_cifar_qat import make_vit_step
    from repro_torch.kernels import dispatch
    from repro_torch.models import vit
    from repro_torch.optim import init_opt_state
    cfg, ocfg = train_vit_config(), train_recipe_opt()
    log(f"[train] deit-s: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.img_size} px / patch {cfg.patch}, {cfg.n_classes} classes, "
        f"batch {TRAIN_BATCH}, fake w4/a8/attn7, LAMB lr {ocfg.lr} no decay, "
        f"warm-up {ocfg.warmup_steps}, {TRAIN_HEAD_STEPS} head-only + "
        f"{TRAIN_STEPS - TRAIN_HEAD_STEPS} full steps, random weights from "
        f"seed 0, synthetic class blobs")
    params = vit.init_params(cfg, seed=0, device="cuda")
    opt = init_opt_state(params)
    steps = (make_vit_step(cfg, ocfg, head_only=True),
             make_vit_step(cfg, ocfg, head_only=False))
    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    moved = None
    for i in range(TRAIN_STEPS):
        batch = image_batch(i, batch=TRAIN_BATCH, img=cfg.img_size,
                            device="cuda")
        before = clone_tree(params) if i == 0 else None
        (params, opt, m), t = timed(
            lambda: steps[i >= TRAIN_HEAD_STEPS](params, opt, batch))
        losses.append(float(m["loss"]))
        ms.append(t)
        if before is not None:
            moved = frozen_but(before, params, "head")
            del before
    peak = torch.cuda.max_memory_allocated() / 2**30
    head_ms = sum(ms[2:TRAIN_HEAD_STEPS]) / (TRAIN_HEAD_STEPS - 2)
    full_ms = sum(ms[TRAIN_HEAD_STEPS + 2:]) / (TRAIN_STEPS
                                                - TRAIN_HEAD_STEPS - 2)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"[train] deit-s losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"[train] deit-s mean loss of the first 5 steps {first:.4f}, of the "
        f"last 5 {last:.4f}; leaves moved by the first head-only step other "
        f"than head: {moved}")
    log(f"[train] deit-s {head_ms:.3f} ms per head-only step, {full_ms:.3f} "
        f"ms per full step (CUDA events, mean after 2 warm-up steps of each "
        f"phase; {TRAIN_BATCH / full_ms * 1e3:.1f} images/s); peak memory "
        f"{peak:.2f} GiB ({card})")
    pp, oo = clone_tree(params), clone_tree(opt)      # the recipe's copy
    log_profile(f"[train] deit-s full step (batch {TRAIN_BATCH}; {card})",
                lambda: steps[1](pp, oo, batch), 2, full_ms)
    deterministic_cost(lambda: steps[1](pp, oo, batch), card)
    del pp, oo

    qc_int = cfg.quant.replace(mode="int", backend="cuda")
    icfg = cfg.replace(quant=qc_int)
    held = image_batch(10**6, batch=TRAIN_BATCH, img=cfg.img_size,
                       device="cuda")
    with torch.no_grad():
        fake = vit.forward(params, held["images"], cfg)
        iparams = integerize_params(params, qc_int)
        torch.cuda.synchronize()
        dispatch.reset_stats()
        dispatch.reset_launches()
        logits = vit.forward(iparams, held["images"], icfg)
        torch.cuda.synchronize()
    launches, snap = dispatch.launch_counts(), dispatch.snapshot()
    check_route("[train] deit-s int forward", "cuda", launches, snap,
                ("qmatmul", "int_attention_fused"))

    def acc(z):
        return float((z.argmax(-1) == held["labels"]).float().mean())

    acc_qat, acc_int = acc(fake), acc(logits)
    gap = rel_err(logits, fake)
    log(f"[train] deit-s held-out batch: acc_qat {acc_qat:.4f} acc_int "
        f"{acc_int:.4f} |int - qat| {abs(acc_int - acc_qat):.4f}; int vs "
        f"fake logits max abs {gap[0]:.3e} rel {gap[1]:.3e} (printed only: "
        f"the fake graph calibrates activations per tensor over the batch, "
        f"the int graph per image, so the two grids differ)")
    want_q = 1 + 6 * cfg.n_layers
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("[train] deit-s: a loss is not finite")
    if moved:
        raise AssertionError(f"[train] deit-s head-only step moved {moved}")
    if not last < first:
        raise AssertionError("[train] deit-s: the loss did not descend")
    if launches["qmatmul"] != want_q or \
            launches["int_attention_fused"] != cfg.n_layers:
        raise AssertionError(f"[train] deit-s int launches {launches}, "
                             f"expected {want_q} qmatmul, {cfg.n_layers} "
                             f"fused")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("[train] deit-s int logits not finite")


def deterministic_cost(step, card, rounds=3, calls=2):
    """ms per call of a training step with the deterministic mode as the
    train entry points run it, without the mode, and with the mode's
    default NaN fill of new memory on; the three interleaved."""
    import contextlib
    import statistics
    import torch
    from repro_torch.launch import train as train_mod
    shipped = train_mod.deterministic

    @contextlib.contextmanager
    def with_fill():
        with shipped():
            torch.utils.deterministic.fill_uninitialized_memory = True
            yield

    variants = {"as shipped": shipped, "off": contextlib.nullcontext,
                "with the NaN fill": with_fill}
    ms = {name: [] for name in variants}
    try:
        for _ in range(rounds):
            for name, mode in variants.items():
                train_mod.deterministic = mode
                for _ in range(calls):
                    ms[name].append(timed(step)[1])
    finally:
        train_mod.deterministic = shipped
    log(f"[train] deit-s full step, deterministic mode (median of "
        f"{rounds * calls} steps, CUDA events, the three interleaved; "
        f"{card}): " + ", ".join(f"{name} {statistics.median(v):.3f} ms"
                                 for name, v in ms.items()))


class FakeQuantTap:
    """Within ``with``: every ``quant.fake_quant`` call records its (x,
    delta, bits, unsigned, output), detached copies (a training step updates
    the weights in place), the output the op's own; with
    ``replay`` (another run's records) each output takes that run's value,
    the gradient still the op's own (``y + (value - y).detach()``)."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay

    def __enter__(self):
        from repro_torch.core import quant
        self.quant, self.orig = quant, quant.fake_quant
        quant.fake_quant = self
        return self

    def __exit__(self, *exc):
        self.quant.fake_quant = self.orig

    def __call__(self, x, delta, bits, unsigned=False):
        y = self.orig(x, delta, bits, unsigned)
        self.calls.append((x.detach().clone(), delta.detach().clone(),
                           bits, unsigned, y.detach()))
        if self.replay is not None:
            y = y + (self.replay[len(self.calls) - 1][4].to(y.device)
                     - y).detach()
        return y


# two runs' x / delta within this many grid steps of each other, on either
# side of a half-integer: a flip that the float sums' order alone decides
FLIP_NEAR = 1e-3


def fake_quant_code(x, delta, bits, unsigned, y, exact=True):
    """(x / delta, code) of one recorded fake_quant call, on the CPU: the
    quotient in the promoted dtype as the op divides, the code read back
    from the call's output.  Raises where the output is not the op's own
    forward on its inputs (a fault in fake_quant on that device); with
    ``exact`` False (a graph that may multiply by 1 / delta instead, as
    XLA's compiled ones do) only where the quotient is not at a rounding
    edge either."""
    import torch
    from repro_torch.core.quant import qrange
    lo, hi = qrange(bits, unsigned=unsigned)
    dt = torch.promote_types(x.dtype, delta.dtype)
    d = delta.cpu().to(dt)
    s = (x.cpu().to(dt) / d).float()
    code = torch.round(y.cpu().float() / d.float())
    off = code != torch.clamp(torch.round(s), lo, hi)
    if not exact:
        off &= (s - torch.floor(s) - 0.5).abs() > FLIP_NEAR
    if bool(off.any()):
        raise AssertionError("a fake_quant output is off its own x / delta")
    return s, code


def code_flips(rec_a, rec_b, *, a_exact=True):
    """Fake-quant codes that differ between two recorded runs of one graph
    (``FakeQuantTap`` records, in call order): (all, primary, shifted).
    Each code is read from its run's output and checked against that run's
    own x / delta (:func:`fake_quant_code`; ``a_exact`` for the first run),
    so a code can differ only where the two quotients do.  A primary flip
    has a rounding edge (a half-integer) between the two quotients, their
    nearest integers differing, and the quotients within FLIP_NEAR of a
    grid step: the float sums' order alone decides it (where the first run
    is not ``a_exact``, a flip with its quotient within FLIP_NEAR of an
    edge is primary too).  A shifted flip sits in a row whose step moved
    by a power of two with x the same within FLIP_NEAR of a step: the fake
    attention's prob grid is (2 / qmax) / Sigma, and Sigma doubles where a
    row's max crosses an integer and its floor-max shift moves by one.
    The others follow from earlier flips."""
    import torch
    if len(rec_a) != len(rec_b) or not rec_a:
        raise AssertionError(f"the runs made {len(rec_a)} and {len(rec_b)} "
                             f"fake_quant calls")
    total = primary = shifted = 0
    for a, b in zip(rec_a, rec_b):
        if a[2:4] != b[2:4] or a[0].shape != b[0].shape:
            raise AssertionError("the runs' fake_quant calls differ")
        (sa, ca), (sb, cb) = fake_quant_code(*a, exact=a_exact), \
            fake_quant_code(*b)
        flip = ca != cb
        edge = (torch.round(sa) != torch.round(sb)) & \
            ((sa - sb).abs() <= FLIP_NEAR)
        if not a_exact:   # the first run's code may be its 1 / delta's
            edge |= (sa - torch.floor(sa) - 0.5).abs() <= FLIP_NEAR
        da, db = a[1].cpu().float(), b[1].cpu().float()
        k = torch.broadcast_to(torch.log2(db / da), sa.shape)
        moved = (torch.round(k) != 0) & ((k - torch.round(k)).abs()
                                         <= FLIP_NEAR)
        same_x = (a[0].cpu().float() - b[0].cpu().float()).abs() <= \
            FLIP_NEAR * da
        total += int(flip.sum())
        primary += int((flip & edge).sum())
        shifted += int((flip & ~edge & moved & same_x).sum())
    return total, primary, shifted


def train_attribution(params_cpu, params_card, imgs, cfg):
    """The step's forward layer by layer on the card, teacher-forced on the
    CPU's residual stream: each layer's code differences (:func:`code_flips`)
    with the card's own codes and, with the CPU's codes replayed, the
    card's own codes on the replayed stream; its update's gap both ways;
    the card's own stream beside it, free-running."""
    import torch
    from repro_torch.models import vit

    def run(fn, replay=None):
        with FakeQuantTap(replay) as tap:
            out = fn()
        return out, tap.calls

    with torch.no_grad():
        x, _ = run(lambda: vit.embed(params_cpu, imgs, cfg))
        xg, _ = run(lambda: vit.embed(params_card, imgs.cuda(), cfg))
        flips, rflips, forced, replayed, free = [], [], [], [], []
        for i in range(cfg.n_layers):
            pc = layer_at(params_cpu["layers"], i)
            pg = layer_at(params_card["layers"], i)
            y, rc = run(lambda: vit.block(x, pc, cfg))
            xc = x.cuda()
            yt, rg = run(lambda: vit.block(xc, pg, cfg))
            yr, rr = run(lambda: vit.block(xc, pg, cfg), replay=rc)
            flips.append(code_flips(rc, rg))
            rflips.append(code_flips(rc, rr))
            want = (y - x).cuda()
            forced.append(rel_err(yt - xc, want)[1])
            replayed.append(rel_err(yr - xc, want)[1])
            xg = vit.block(xg, pg, cfg)
            free.append(rel_err(xg, y.cuda())[1])
            x = y
    return flips, rflips, forced, replayed, free


def train_card_vs_cpu(card):
    """One full training step of DeiT-S at full size on the card and on the
    CPU, same params and batch; then the card's step with the CPU's
    fake-quant values replayed, and the forward layer by layer."""
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.data.synthetic import image_batch
    from repro_torch.examples.train_cifar_qat import make_vit_step
    from repro_torch.models import vit
    from repro_torch.optim import init_opt_state
    cfg, ocfg = train_vit_config(), train_recipe_opt()
    start = vit.init_params(cfg, seed=1, device="cpu")
    params_cpu = clone_tree(start)
    batch = image_batch(0, batch=TRAIN_CPU_BATCH, img=cfg.img_size)
    batch_card = {k: v.to("cuda") for k, v in batch.items()}
    step = make_vit_step(cfg, ocfg, head_only=False)

    def on_card():
        return tree_lib.tree_map(lambda t: t.to("cuda"), start)

    t0 = time.perf_counter()
    with FakeQuantTap() as tap:
        _, _, mc = step(params_cpu, init_opt_state(params_cpu), batch)
    cpu_s = time.perf_counter() - t0
    params_card = on_card()
    (_, _, mg), card_ms = timed(lambda: step(
        params_card, init_opt_state(params_card), batch_card))
    replay_card = on_card()
    with FakeQuantTap(replay=tap.calls) as rtap:
        _, _, mr = step(replay_card, init_opt_state(replay_card), batch_card)
    step_flips = code_flips(tap.calls, rtap.calls)
    del tap, rtap, replay_card

    def gaps(m):
        return (abs(float(m["loss"]) - float(mc["loss"]))
                / abs(float(mc["loss"])),
                abs(float(m["grad_norm"]) - float(mc["grad_norm"]))
                / float(mc["grad_norm"]))

    (loss_gap, gn_gap), (loss_r, gn_r) = gaps(mg), gaps(mr)
    leaf_gaps = [(p, rel_err(g.cpu(), c)[1]) for (p, c), (_, g) in zip(
        tree_lib.leaves_with_paths(params_cpu),
        tree_lib.leaves_with_paths(params_card))]
    log(f"[train] card vs cpu: DeiT-S full size, batch {TRAIN_CPU_BATCH}, "
        f"one full step (card {card_ms:.3f} ms, CUDA events, a first step; "
        f"CPU {cpu_s:.1f} s with {torch.get_num_threads()} threads; {card}): "
        f"loss {float(mg['loss']):.7f} vs {float(mc['loss']):.7f} rel "
        f"{loss_gap:.3e} (tol {TRAIN_LOSS_RTOL}); grad norm "
        f"{float(mg['grad_norm']):.7f} vs {float(mc['grad_norm']):.7f} rel "
        f"{gn_gap:.3e} (tol {TRAIN_GNORM_RTOL})")
    log(f"[train] card vs cpu with the CPU's fake-quant values replayed on "
        f"the card (float sums alone): loss rel {loss_r:.3e}, grad norm rel "
        f"{gn_r:.3e} (tol {TRAIN_REPLAY_RTOL}); the card's own codes there "
        f"that differ from the CPU's (all, at a rounding edge, in a row "
        f"whose floor-max shift moved) {step_flips}")
    log("[train] card vs cpu, each leaf's largest relative gap after the "
        "update (printed only: Adam's first step moves an element by about "
        "lr * sign(g), so a zero-initialized bias or a gradient near 0 can "
        "move the other way): "
        + " ".join(f"{p} {e:.2e}" for p, e in leaf_gaps))
    flips, rflips, forced, replayed, free = train_attribution(
        start, on_card(), batch["images"], cfg)

    def counts(fl):
        return " ".join(f"{n}({p},{s})" for n, p, s in fl)

    log(f"[train] card vs cpu, the step's forward layer by layer, each "
        f"layer on the CPU's residual stream: fake-quant codes that differ "
        f"(of them at a rounding edge, in a shifted row) {counts(flips)}; "
        f"with the CPU's codes replayed {counts(rflips)}; update max rel "
        f"with the card's codes {' '.join(f'{e:.2e}' for e in forced)} "
        f"(tol {LOGITS_RTOL}), with the CPU's codes replayed "
        f"{' '.join(f'{e:.2e}' for e in replayed)} (tol "
        f"{TRAIN_REPLAY_RTOL}); free-running residual stream max rel "
        f"{' '.join(f'{e:.2e}' for e in free)}")
    if loss_r > TRAIN_REPLAY_RTOL or gn_r > TRAIN_REPLAY_RTOL or \
            max(replayed) > TRAIN_REPLAY_RTOL:
        raise AssertionError("[train] card vs cpu: a gap with the codes "
                             "equal")
    # on a stream with the CPU's codes replayed, every code of the card's
    # own that differs must have a cause of its own: a rounding edge or a
    # moved floor-max shift
    if any(n != p + s for n, p, s in [step_flips] + rflips):
        raise AssertionError("[train] card vs cpu: a code differs on the "
                             "replayed stream with no edge or shift")
    if loss_gap <= TRAIN_LOSS_RTOL and gn_gap <= TRAIN_GNORM_RTOL:
        return
    # past the bounds: only code flips may explain it, each layer's from a
    # flip of its own at an edge or a shift (its input is the CPU's)
    if loss_gap > TRAIN_FREE_LOSS_RTOL or gn_gap > TRAIN_FREE_GNORM_RTOL:
        raise AssertionError(f"[train] card vs cpu: the free-running step "
                             f"is past {TRAIN_FREE_LOSS_RTOL} / "
                             f"{TRAIN_FREE_GNORM_RTOL}")
    if not any(n for n, _, _ in flips) or max(forced) > LOGITS_RTOL or \
            any(n and not p + s for n, p, s in flips):
        raise AssertionError("[train] card vs cpu: a gap that no code flip "
                             "at a rounding edge or shift explains")
    log("[train] card vs cpu: the free-running step is past its bounds; "
        "with the codes equal it is within them, and each layer's codes "
        "differ from flips of its own at rounding edges or shifts on, so "
        "the flips explain the gap")


def train_lm(card):
    """make_train_step at Qwen2.5-32B's published widths, 2 layers, bf16:
    head-only steps, then full steps."""
    import math
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import QuantConfig, count_params
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = get_config("qwen2.5-32b").replace(
        n_layers=TRAIN_LM_LAYERS, quant=QuantConfig(w_bits=4, a_bits=8,
                                                    attn_bits=7, mode="fake"))
    ocfg = OptConfig(total_steps=4, warmup_steps=1)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_LM_SEQ,
                      global_batch=TRAIN_LM_BATCH)
    params = lm.init_params(cfg, seed=0, device="cuda")
    opt = init_opt_state(params)
    n = count_params(params)
    log(f"[train] lm: Qwen2.5-32B widths (d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}), {cfg.n_layers} of 64 layers, "
        f"{cfg.dtype}, remat {cfg.remat}, batch {TRAIN_LM_BATCH} x "
        f"{TRAIN_LM_SEQ} tokens, fake w4/a8/attn7, LAMB; {n / 1e9:.3f} B "
        f"params, random from seed 0")
    head, full = (make_train_step(cfg, ocfg, last_layer_only=True),
                  make_train_step(cfg, ocfg))
    before = clone_tree(params)
    losses, ms = [], []
    for i in range(2):
        batch = lm_batch(dcfg, i, device="cuda")
        (params, opt, m), t = timed(lambda: head(params, opt, batch))
        losses.append(float(m["loss"]))
        ms.append(t)
    moved = frozen_but(before, params, "lm_head")
    del before
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for i in range(2, 4):
        batch = lm_batch(dcfg, i, device="cuda")
        (params, opt, m), t = timed(lambda: full(params, opt, batch))
        losses.append(float(m["loss"]))
        ms.append(t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log_profile(f"[train] lm full step ({card})",
                lambda: full(params, opt, batch), 1, ms[3])
    log(f"[train] lm losses {' '.join(f'{x:.4f}' for x in losses)}; leaves "
        f"moved by the head-only steps other than lm_head: {moved}")
    log(f"[train] lm {ms[1]:.3f} ms per head-only step, {ms[3]:.3f} ms per "
        f"full step (CUDA events, each phase's second step); peak memory "
        f"over the full steps {peak:.2f} GiB ({card})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("[train] lm: a loss is not finite")
    if moved:
        raise AssertionError(f"[train] lm head-only steps moved {moved}")


def train_restart(card):
    """train() on the CLI's default (Qwen2.5-32B SMOKE, fake w4/a8): an
    uninterrupted run against one stopped and resumed from its checkpoint,
    bitwise on the card."""
    import shutil
    import tempfile
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.optim import OptConfig
    cfg = smoke_config("qwen2.5-32b").replace(
        quant=QuantConfig(w_bits=4, a_bits=8, mode="fake"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=4)
    ocfg = OptConfig(total_steps=RESTART_STEPS)
    root = tempfile.mkdtemp(prefix="train_restart_")

    def run(steps, d):
        return train(cfg, TrainConfig(steps=steps, ckpt_every=RESTART_EVERY,
                                      ckpt_dir=os.path.join(root, d)),
                     ocfg, dcfg, verbose=False, device="cuda")

    try:
        (full, _, mfull, _), full_ms = timed(lambda: run(RESTART_STEPS, "a"))
        run(RESTART_STOP, "b")
        resumed, _, mres, last = run(RESTART_STEPS, "b")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    diff = [p for (p, a), (_, b) in zip(tree_lib.leaves_with_paths(full),
                                        tree_lib.leaves_with_paths(resumed))
            if not torch.equal(a, b)]
    log(f"[train] restart: train() on {cfg.name}, {RESTART_STEPS} steps, a "
        f"checkpoint every {RESTART_EVERY}, against a run stopped at "
        f"{RESTART_STOP} and resumed (last step {last}): final loss "
        f"{float(mfull['loss']):.6f} vs {float(mres['loss']):.6f}; leaves "
        f"that differ {diff}; uninterrupted run {full_ms / 1e3:.2f} s "
        f"({card})")
    if diff or last != RESTART_STEPS - 1:
        raise AssertionError(f"[train] restart not bitwise: {diff}")


def phase_train():
    card = card_line()
    train_deit(card)
    train_card_vs_cpu(card)
    train_lm(card)
    train_restart(card)


# Each kernel of the kernels line: its source and the TPU kernel it replaces.
KERNELS = {
    "qmatmul": ("qmatmul.cu", "qmatmul.py:119"),
    "int_attention_fused": ("int_attention.cu", "int_attention.py:569"),
    "int_paged_decode_attention": ("int_attention.cu", "int_attention.py:752"),
    "int_decode_attention": ("int_attention.cu", "int_attention.py:649"),
    "pq_layernorm": ("pq_layernorm.cu", "pq_layernorm.py:48"),
    "int_attention": ("int_attention.cu", "int_attention.py:496"),
    # qmatmul's accumulator output: the same kernel, epilogue skipped
    "qmatmul_acc": ("qmatmul.cu", "qmatmul.py:119"),
}
# the counted runs of each kernel's main paths (the kernels line's
# launches: their sum, and each path's count)
MAIN_PATHS = {"qmatmul": ("serve", "archs", "recurrent", "serve-recurrent",
                          "encdec", "dist", "tp", "tp-shard-bodies",
                          "tp-families", "tp-train", "dryrun"),
              "int_attention_fused": ("serve", "archs", "recurrent",
                                      "serve-recurrent", "encdec", "dist",
                                      "tp", "tp-shard-bodies", "tp-families",
                                      "tp-train"),
              "int_paged_decode_attention": ("serve", "archs",
                                             "serve-recurrent"),
              "int_decode_attention": ("ring", "archs", "recurrent",
                                       "encdec", "dist", "tp",
                                       "tp-shard-bodies", "tp-families",
                                       "tp-train", "dryrun"),
              "pq_layernorm": ("ops",), "int_attention": ("ops",),
              "qmatmul_acc": ("tp", "tp-shard-bodies", "tp-families",
                              "tp-train", "dryrun")}
# qmatmul timed at every (M, N, K) of one Qwen2.5-32B layer and its
# lm_head at decode and prefill rows, int8 and packed, then DeiT-S's
# linears (int8, as the model runs them)
QMM_TIMES = [(m, n, k, packed) for m in (4, 256) for n, k in QMM_NK
             for packed in (False, True)] + \
    [(m, n, k, False) for m, n, k in QMM_DEIT] + \
    [(m, n, k, False) for m in (4, 256) for n, k in QMM_HEADS] + \
    [(m, n, k, False) for m, n, k in QMM_FAMILIES + QMM_DIST + QMM_DRYRUN]
# the accumulator output at Qwen2.5-32B's wo and down on one of 4 [tp]
# ranks (K 1280 and 6912), decode and prefill rows, int8 and packed; then
# [dryrun] (b)'s
QMM_ACC_TIMES = [(m, 5120, k, packed) for m in (4, 256) for k in (1280, 6912)
                 for packed in (False, True)] + QMM_DRYRUN_ACC
# Llama-4-Scout's expert product (din 5120, dout 8192) as (experts,
# capacity): the [archs] prefill's 16 x 20, a decode step's 16 x 1, the
# all-to-all body's on one card (16 x 80) and on one of 4 ranks (its 4
# local experts over 4 x 20 slots); Phi-3.5-MoE's (din 4096, dout 6400)
# on one of 4 ranks (4 x 160)
EXPERT_TIMES = ((16, 20), (16, 1), (16, 80), (4, 80), (4, 160, 4096, 6400))
# [tp-shard-bodies]' row products timed: a quarter of K on one of 4 ranks
QMM_SHARD_TIMES = [row for row in QMM_SHARD if row[2] in (1280, 6912, 2048,
                                                          1024)]
# (kv_bits, span, pos, G, D): the ring phase's shapes (64-token prompts, so
# the last decode step reads positions 0..79) first, then full rings, then
# a full ring at chatglm3-6b's G 16.
RING_TIMES = [(8, 1024, 79, 5, 128), (4, 1024, 79, 5, 128),
              (8, 8192, 79, 5, 128), (8, 4096, 4095, 5, 128),
              (8, 8192, 8191, 5, 128), (4, 8192, 8191, 5, 128),
              (8, 8192, 8191, 16, 128)]
# the shape of each kernel's row in the kernels line
ROW_OF = {"qmatmul": (256, 27648, 5120, False), "int_attention_fused": "qwen",
          "int_paged_decode_attention": PAGED_CHECKS[0],
          "int_decode_attention": RING_TIMES[0],
          "pq_layernorm": PQLN_CASES[0], "int_attention": "deit-ops",
          "qmatmul_acc": (256, 5120, 6912, False)}


def phase_time(g, launches, errs):
    """Every kernel with CUDA events beside its bound, its plain version and
    the nearest PyTorch call; returns the kernels line's rows (``launches``:
    each kernel's counts by main path)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quant import unpack_int4
    from repro_torch.kernels import int_attention as ia
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.pq_layernorm import pq_layernorm
    from repro_torch.kernels.qmatmul import qmatmul, qmatmul_acc
    rows = {}                    # name -> (ms, plain ms, bound, by, library)

    def keep(name, key, t):
        if ROW_OF[name] == key:
            rows[name] = t

    for m, n, k, packed in QMM_TIMES:
        x, w, s, b, rs = qmatmul_inputs(g, m, n, k, packed)
        blocks = dispatch.qmatmul_blocks(m, n, k)
        call = lambda: qmatmul(x, w, s, b, rs, blocks=blocks, packed=packed)
        ms = cuda_ms(call)
        dms = device_ms(call)
        pms = cuda_ms(lambda: ref.qmatmul_ref(x, w, s, b, rs), iters=3,
                      warmup=1)
        # Yardstick the port never calls: torch._int_mm (int8 x int8 ->
        # int32, no epilogue) on the same codes (W unpacked when packed);
        # it takes M > 16 only, so decode rows time it over x zero-padded
        # to 32 rows.
        xi = F.pad(x, (0, 0, 0, 32 - m)) if m <= 16 else x
        wi = unpack_int4(w) if packed else w
        # _int_mm takes N in multiples of 8: W padded with rows of zeros
        wi = F.pad(wi, (0, 0, 0, -n % 8))
        lib = cuda_ms(lambda: torch._int_mm(xi, wi.t()))
        del wi
        nbytes = x.numel() + w.numel() + 8 * n + 4 * m + 4 * m * n
        bnd, by = bound_ms(nbytes, 2 * m * n * k)
        how = (" (x padded to 32 rows)" if m <= 16 else "") + \
            (" (W unpacked)" if packed else "") + \
            (f" (W padded to {n + -n % 8} rows)" if n % 8 else "")
        log(f"[time] qmatmul M={m} N={n} K={k} packed={packed} plan "
            f"{blocks}: {ms:.4f} ms ({dev_str(dms, bnd)}), bound {bnd:.4f} "
            f"ms ({by}), plain {pms:.4f} ms, _int_mm{how} {lib:.4f} ms")
        keep("qmatmul", (m, n, k, packed), (ms, pms, bnd, by, lib))
        del x, w, s, b, rs

    for m, n, k, packed in QMM_ACC_TIMES:
        x, w, *_ = qmatmul_inputs(g, m, n, k, packed)
        blocks = dispatch.qmatmul_blocks(m, n, k)
        call = lambda: qmatmul_acc(x, w, blocks=blocks, packed=packed)
        ms, dms = cuda_ms(call), device_ms(call)
        pms = cuda_ms(lambda: ref.qmatmul_acc_ref(x, w), iters=3, warmup=1)
        # torch._int_mm computes the same int32 product (M > 16 only:
        # decode rows over x zero-padded to 32 rows; W unpacked)
        xi = F.pad(x, (0, 0, 0, 32 - m)) if m <= 16 else x
        wi = unpack_int4(w) if packed else w
        lib = cuda_ms(lambda: torch._int_mm(xi, wi.t()))
        del wi
        nbytes = x.numel() + w.numel() + 4 * m * n
        bnd, by = bound_ms(nbytes, 2 * m * n * k)
        how = (" (x padded to 32 rows)" if m <= 16 else "") + \
            (" (W unpacked)" if packed else "")
        log(f"[time] qmatmul_acc M={m} N={n} K={k} packed={packed} plan "
            f"{blocks}: {ms:.4f} ms ({dev_str(dms, bnd)}), bound {bnd:.4f} "
            f"ms ({by}), plain {pms:.4f} ms, _int_mm{how} {lib:.4f} ms")
        keep("qmatmul_acc", (m, n, k, packed), (ms, pms, bnd, by, lib))
        del x, w

    for m, n, k, packed in QMM_SHARD_TIMES:
        x, w, sc, _, _ = qmatmul_inputs(g, m, n, k, packed)
        blocks = dispatch.qmatmul_blocks(m, n, k)
        call = lambda: qmatmul(x, w, sc, blocks=blocks, packed=packed)
        ms, dms = cuda_ms(call), device_ms(call)
        pms = cuda_ms(lambda: ref.qmatmul_ref(x, w, sc), iters=3, warmup=1)
        xi = F.pad(x, (0, 0, 0, 32 - m)) if m <= 16 else x
        wi = unpack_int4(w) if packed else w
        lib = cuda_ms(lambda: torch._int_mm(xi, wi.t()))
        del wi
        # x, W, the scales, the f32 output
        nbytes = x.numel() + w.numel() + 4 * n + 4 * m * n
        bnd, by = bound_ms(nbytes, 2 * m * n * k)
        how = (" (x padded to 32 rows)" if m <= 16 else "") + \
            (" (W unpacked)" if packed else "")
        log(f"[time] qmatmul shard body M={m} N={n} K={k} packed={packed} "
            f"(scaled epilogue) plan {blocks}: {ms:.4f} ms "
            f"({dev_str(dms, bnd)}), bound {bnd:.4f} ms ({by}), plain "
            f"{pms:.4f} ms, _int_mm{how} {lib:.4f} ms")
        del x, w, sc

    for row in EXPERT_TIMES:
        time_expert(g, row[1], row[0], *row[2:])

    for name, case in ATTN_CASES.items():
        for kname, t in time_attention(g, name, case, both=True).items():
            keep(kname, name, t)
    for name in ATTN_FAMILIES:
        time_attention(g, name, family_attention_case(name), both=False)

    for row, hkv in [(row, 8) for row in PAGED_CHECKS + PAGED_LONG] + \
            [PAGED_SERVE_REC]:
        args, kw = paged_inputs(g, *row, hkv=hkv)
        q, kp, vp, sc, vs, pt, pos = args
        window = kw["window"]
        ms = cuda_ms(lambda: ia.int_paged_decode_attention(*args, **kw))
        dms = device_ms(lambda: ia.int_paged_decode_attention(*args, **kw))
        pms = cuda_ms(lambda: ref.int_paged_decode_attention_ref(
            q, kp, vp, sc, vs, pt, pos, attn_bits=7, bk=kp.shape[2],
            window=window, k_page_scale=kw["k_page_scale"],
            v_page_scale=kw["v_page_scale"]), iters=3, warmup=1)
        b, hkv, grp, d = q.shape
        ps, dk = kp.shape[2], kp.shape[3]
        # the live keys (and pages holding them) of this run's rows
        live, pages = [], 0
        for p in pos.tolist():
            if p >= 0:
                lo = 0 if window is None else max(p - window + 1, 0)
                live.append(p - lo + 1)
                pages += p // ps - lo // ps + 1
        nbytes = hkv * pages * ps * dk * 2 + q.numel() + 4 * q.numel() + \
            4 * (2 * b + 2 * pages) + 4 * pt.numel() + 4 * b
        bnd, by = bound_ms(nbytes, 4 * d * grp * hkv * sum(live))
        lib = paged_sdpa_ms(g, q, pt, pos, ps, window)
        log(f"[time] paged decode kv_bits={row[0]} B={b} Hkv={hkv} G={grp} "
            f"D={d} "
            f"pages {pt.shape[1]} window {window} live keys {live}: "
            f"{ms:.4f} ms ({dev_str(dms, bnd)}), bound {bnd:.4f} ms ({by}), "
            f"plain {pms:.4f} ms, bf16 SDPA over the gathered pages, masked "
            f"{lib:.4f} ms")
        keep("int_paged_decode_attention", row, (ms, pms, bnd, by, lib))

    for kv_bits, span, pos, grp, d in RING_TIMES:
        keep("int_decode_attention", (kv_bits, span, pos, grp, d),
             time_ring(g, kv_bits, span, pos, None, grp, d))
    for row in RING_FAMILIES + RING_DRYRUN:
        time_ring(g, *row)

    for case in PQLN_CASES:
        args, kw = pqln_inputs(g, *case)
        x, gamma, beta, delta = args
        n_rows, d = x.shape
        # copies of x cycled through, together above the 50 MB L2, so each
        # call reads its x from device memory, as a model's layer would
        nbytes_x = x.numel() * x.element_size()
        xs = [x] + [x.clone() for _ in range(-(-L2_PAST // nbytes_x) - 1)]
        nxt = itertools.cycle(xs).__next__
        call = lambda: pq_layernorm(nxt(), gamma, beta, delta, **kw)
        ms, dms = cuda_ms(call), device_ms(call)
        pms = cuda_ms(lambda: ref.pq_layernorm_ref(nxt(), gamma, beta, delta,
                                                   **kw), iters=3, warmup=1)
        if kw["rms_only"]:
            gx = gamma.to(x.dtype)
            lib_call = lambda: F.rms_norm(nxt(), (d,), gx, 1e-6)
        else:
            lib_call = lambda: F.layer_norm(nxt(), (d,), gamma, beta, 1e-6)
        lib, lib_dms = cuda_ms(lib_call), device_ms(lib_call)
        # x once, gamma (and beta), one byte a code; ~11 f32 operations an
        # element
        nbytes = nbytes_x + 4 * d * (1 + (beta is not None)) + n_rows * d
        bnd, by = bound_ms(nbytes, 11 * n_rows * d, PEAK_F32_OPS)
        log(f"[time] pq_layernorm rows={n_rows} d={d} {x.dtype} "
            f"bits={kw['bits']} rms_only={kw['rms_only']} (x from {len(xs)} "
            f"copies, {len(xs) * nbytes_x / 1e6:.1f} MB): {ms:.4f} ms "
            f"({dev_str(dms, bnd)}), bound {bnd:.4f} ms ({by}), plain "
            f"{pms:.4f} ms, F.{'rms_norm' if kw['rms_only'] else 'layer_norm'}"
            f" (LN only, no quantizer) {lib:.4f} ms ({dev_str(lib_dms)})")
        keep("pq_layernorm", case, (ms, pms, bnd, by, lib))
        del xs

    line = []
    for name, (src, replaces) in KERNELS.items():
        ms, pms, bnd, by, lib = rows[name]
        line.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": f"src/repro/kernels/{replaces}",
                     "launches": sum(launches[name].values()),
                     "launches_by_path": launches[name],
                     "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": pms, "bound_ms": bnd,
                     "bound_by": by, "library_ms": lib})
    return line


def attention_pairs(h, sq, sk, sq_mod, causal, window):
    """The (query, key) pairs a prefill attention must score: per query
    row at position p (row r at ``r % sq_mod``), keys <= p when causal,
    and > p - window under a window."""
    import numpy as np
    p = np.arange(sq) % (sq_mod or sq)
    hi = np.minimum(p + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(p - window + 1, 0) if window is not None else 0
    return h * int(np.maximum(hi - lo, 0).sum())


def time_attention(g, name, case, both):
    """One prefill attention shape: the fused kernel (and the two-pass one
    when ``both``) with CUDA events and device time, beside its bound, its
    plain version and bf16 SDPA; returns {kernel: (ms, plain ms, bound, by,
    library ms)}."""
    from repro_torch.kernels import int_attention as ia
    args, kw = attention_inputs(g, *case)
    q, k, v, sc, vs = args
    h, sq, d = q.shape
    sk = k.shape[1]
    pms = cuda_ms(lambda: ia.int_attention_plain(*args, **kw), iters=3,
                  warmup=1)
    pairs = attention_pairs(h, sq, sk, kw["sq_mod"], kw["causal"],
                            kw["window"])
    nbytes = q.numel() + k.numel() + v.numel() + 4 * sc.numel() + \
        4 * vs.numel() + 4 * h * sq * d
    bnd, by = bound_ms(nbytes, 4 * d * pairs)      # QK^T and PV
    lib = sdpa_ms(g, h, sq, sk, d, kw["causal"], kw["sq_mod"], kw["window"])
    kernels = (("int_attention_fused", ia.int_attention_fused),
               ("int_attention", ia.int_attention))
    out = {}
    for kname, kern in kernels[:2 if both else 1]:
        ms = cuda_ms(lambda: kern(*args, **kw))
        dms = device_ms(lambda: kern(*args, **kw))
        log(f"[time] {kname} {name} H={h} Sq={sq} Sk={sk} D={d} causal="
            f"{kw['causal']} window={kw['window']} bq={kw['bq']} "
            f"bk={kw['bk']}: {ms:.4f} ms ({dev_str(dms, bnd)}), bound "
            f"{bnd:.4f} ms ({by}), plain {pms:.4f} ms, bf16 SDPA {lib:.4f} ms")
        out[kname] = (ms, pms, bnd, by, lib)
    return out


def time_ring(g, kv_bits, span, pos, window, grp, d, h=32):
    """One ring decode shape: the kernel with CUDA events and device time,
    beside its bound (the live keys' bytes), its plain version and bf16
    SDPA over the live keys; returns (ms, plain ms, bound, by, library
    ms)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import int_attention as ia
    args = ring_inputs(g, kv_bits, span, pos, grp, d, h)
    q, k, v, sc, vs, kpos, posd = args
    kw = dict(attn_bits=7, packed=kv_bits == 4, window=window,
              bk=dispatch.decode_blocks(span, d))
    ms = cuda_ms(lambda: ia.int_decode_attention(*args, **kw))
    dms = device_ms(lambda: ia.int_decode_attention(*args, **kw))
    pms = cuda_ms(lambda: ia.int_decode_attention_plain(*args, **kw),
                  iters=3, warmup=1)
    dk = k.shape[2]
    live = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        live &= kpos > pos - window
    n_live = int(live.sum())
    bk = kw["bk"]
    live_blocks = int(live.reshape(-1, bk).any(dim=1).sum()) \
        if span % bk == 0 else -(-span // bk)
    # least bytes: q, the slot map, pos, scales, live K/V rows, out
    nbytes = q.numel() + 4 * span + 4 + 8 * h + 2 * h * n_live * dk + \
        4 * h * grp * d
    ops = 4 * d * grp * h * n_live
    bnd, by = bound_ms(nbytes, ops)
    blk_bnd, _ = bound_ms(nbytes + 2 * h * (live_blocks * bk - n_live) * dk,
                          ops)
    lib = ring_sdpa_ms(g, h, n_live, grp, d)
    log(f"[time] ring decode kv_bits={kv_bits} H={h} G={grp} D={d} "
        f"span={span} bk={bk} pos={pos} window={window} (live keys {n_live}, "
        f"live blocks {live_blocks}): {ms:.4f} ms ({dev_str(dms, bnd)}), "
        f"bound {bnd:.4f} ms ({by}; {blk_bnd:.4f} ms over the whole live "
        f"blocks), plain {pms:.4f} ms, bf16 SDPA over the live keys "
        f"{lib:.4f} ms")
    return ms, pms, bnd, by, lib


def time_expert(g, cap, e=16, din=5120, dout=8192):
    """``dense_expert``'s kernel route (the activation quantizer, one
    qmatmul launch an expert, the stack) beside its bound and its plain
    version; printed only (its launches are qmatmul's)."""
    import torch
    from repro_torch.core.api import QuantConfig
    from repro_torch.layers.moe import dense_expert
    p = {"w_q": torch.randint(-8, 8, (e, din, dout), generator=g,
                              device="cuda", dtype=torch.int8),
         "w_scale": torch.rand((e, 1, dout), generator=g, device="cuda")}
    x = torch.randn((e, cap, din), generator=g, device="cuda").to(
        torch.bfloat16)
    qc = QuantConfig(w_bits=4, a_bits=8, mode="int", backend="cuda")
    call = lambda: dense_expert(x, p, qc)
    ms, dms = cuda_ms(call), device_ms(call)
    pms = cuda_ms(lambda: dense_expert(x, p, qc.replace(backend="torch")),
                  iters=3, warmup=1)
    # Yardstick the port never calls: torch._int_mm on each expert's codes
    # (x's codes padded to 32 rows where the capacity is 16 or fewer)
    xi = torch.randint(-128, 128, (e, max(cap, 32), din), generator=g,
                       device="cuda", dtype=torch.int8)
    wt = p["w_q"].transpose(-1, -2).contiguous()
    lib = cuda_ms(lambda: [torch._int_mm(xi[i], wt[i].t())
                           for i in range(e)])
    del xi, wt
    # x (bf16), the codes, the scales, the bf16 output; int8 products
    nbytes = 2 * x.numel() + e * din * dout + 4 * e * dout + 2 * e * cap * dout
    bnd, by = bound_ms(nbytes, 2 * e * cap * din * dout)
    log(f"[time] expert product E={e} capacity={cap} din={din} dout={dout} "
        f"(bf16, {e} qmatmul launches): {ms:.4f} ms ({dev_str(dms, bnd)}), "
        f"bound {bnd:.4f} ms ({by}), plain {pms:.4f} ms, _int_mm (one an "
        f"expert{', x padded to 32 rows' if cap < 32 else ''}) {lib:.4f} ms")


def sdpa_ms(g, h, sq, sk, d, causal, sq_mod, window=None):
    """Yardstick the port never calls: bf16 SDPA on the same attention —
    GQA groups stacked along Sq (sq_mod) become query heads; a window
    becomes a boolean mask."""
    import torch
    import torch.nn.functional as F
    grp = sq // (sq_mod or sq)
    s = sq // grp
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda",
                                    dtype=torch.bfloat16)
    qb, kb, vb = mk(1, h * grp, s, d), mk(1, h, sk, d), mk(1, h, sk, d)
    mask = None
    if window is not None:
        qp = torch.arange(s, device="cuda")[:, None]
        kp = torch.arange(sk, device="cuda")[None, :]
        mask = (kp > qp - window) & (kp <= qp if causal else True)
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=grp > 1))


def ring_sdpa_ms(g, h, n, grp, d):
    """Yardstick the port never calls: one bf16 SDPA over the ring's ``n``
    live keys, dequantized and gathered (``h`` head-folds, G query heads
    each)."""
    import torch
    import torch.nn.functional as F
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda",
                                    dtype=torch.bfloat16)
    qb, kb, vb = mk(h, grp, 1, d), mk(h, 1, n, d), mk(h, 1, n, d)
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, enable_gqa=grp > 1))


def paged_sdpa_ms(g, q, pt, pos, ps, window=None):
    """Yardstick the port never calls: one bf16 SDPA per decode step over
    every row's pages gathered into a dense (B, Hkv, max_pages * ps, D)
    cache, masked to each row's positions (and window)."""
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
    kpos = torch.arange(total, device="cuda")[None, :]
    mask = kpos <= pos.clamp(min=0)[:, None]
    if window is not None:
        mask &= kpos > pos[:, None] - window
    mask = mask[:, None, None, :]
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, enable_gqa=True))


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py needs the repository around it "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    # [train] runs deterministic algorithms (repro_torch.launch.train);
    # cuBLAS reads this before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        phase_ring_split(g)
        paths = {}
        paths["serve"], params = phase_serve()
        paths["ring"] = phase_ring(params)
        phase_faults(params)
        del params
        torch.cuda.empty_cache()
        paths["archs"] = phase_archs()
        paths["recurrent"] = phase_recurrent()
        paths["serve-recurrent"] = phase_serve_recurrent()
        paths["encdec"] = phase_encdec()
        paths.update(phase_dist())
        paths["dryrun"] = phase_dryrun()
        phase_quickstart()
        vparams, imgs = phase_vit()
        paths["ops"], ops_errs = phase_ops(vparams, imgs)
        phase_lowbit(imgs)
        for name, err in ops_errs.items():
            errs[name] = max(errs[name], err)
        launches = {name: {path: paths[path][name]
                           for path in MAIN_PATHS[name]}
                    for name in KERNELS}
        del vparams, imgs
        torch.cuda.empty_cache()
        phase_train()
        torch.cuda.empty_cache()
        kernels = phase_time(g, launches, errs)
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
