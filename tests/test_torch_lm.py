"""The port's LM (paged prefill / decode) held against the JAX package at
SMOKE widths, and the reference's five bitwise serving invariants held
inside the port.

Parity with JAX: parameters come from ``repro``'s ``init_params`` +
``integerize_params`` and cross over through ``repro_torch.interop``.  Page
tables and positions must be EQUAL.  XLA on the CPU contracts
``a * b + c`` into FMAs where the port (and its CUDA kernels) round twice,
so activations differ in the last bit and now and then one lands on the
other side of a quantizer's rounding boundary: a code moves by one step
and later layers and steps carry the difference.  So: logits within 1e-6
of their max in at least half of all steps (no systematic drift) and
within FLIP_TOL in every step; greedy tokens equal wherever JAX's top-2
margin exceeds the difference; page-pool codes equal but for at most 1%
of entries; scales within 1e-2.

Invariants (tokens bit-identical, on both port backends, kv_bits 8 and 4):
solo vs batch, batched vs one-at-a-time admission, chunked vs one-shot
prefill, shared vs private prefix, resumed vs uninterrupted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.kernels import dispatch as jdispatch
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.core.api import QuantConfig
from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import dispatch
from repro_torch.launch.engine import PagedEngine, Request
from repro_torch.models import lm

torch.set_num_threads(1)

TOL = 1e-6
DIMS = dict(n_layers=2, d_model=48, n_heads=4, kv_heads=2, d_ff=96,
            vocab=64, dtype="float32", q_chunk=16, qkv_bias=True)


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


_JAX_PARAMS = {}


def _jax_model(kv_bits, w_bits=4):
    """JAX config + integerized params (the same weights for any kv_bits)."""
    qj = JQuantConfig(w_bits=w_bits, a_bits=8, attn_bits=7, kv_bits=kv_bits,
                      mode="int")
    jcfg = jlm.LMConfig(name="t", remat=False, quant=qj, **DIMS)
    if w_bits not in _JAX_PARAMS:
        init = jax.jit(lambda key: j_integerize(
            jlm.init_params(key, jcfg.replace(quant=None)), qj))
        _JAX_PARAMS[w_bits] = init(jax.random.PRNGKey(0))
    return jcfg, _JAX_PARAMS[w_bits]


def _port(jp, kv_bits, backend, w_bits=4):
    qt = QuantConfig(w_bits=w_bits, a_bits=8, attn_bits=7, kv_bits=kv_bits,
                     mode="int", backend=backend)
    return (lm.LMConfig(name="t", quant=qt, **DIMS),
            interop.to_torch(jax.tree.map(np.asarray, jp), "cpu"))


_JAX_FNS = {}


def _jax_fns(jcfg):
    """Jitted JAX prefill / decode for one config (traced once per shape)."""
    if jcfg not in _JAX_FNS:
        _JAX_FNS[jcfg] = (
            jax.jit(lambda p, b, c: jlm.paged_prefill(p, b, jcfg, c)),
            jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, jcfg)))
    return _JAX_FNS[jcfg]


def _run_jax(jcfg, jp, toks, lens, pt, steps):
    """JAX prefill + ``steps`` greedy decode steps on the XLA path: logits
    per step, the token fed at each step, and the final cache (numpy)."""
    prefill, decode = _jax_fns(jcfg)
    jc = dict(jlm.init_paged_cache(jcfg, len(lens), 32, page_size=4),
              page_table=jnp.asarray(pt))
    with jdispatch.use_backend("xla"):
        lj, jc = prefill(jp, {"tokens": jnp.asarray(toks),
                              "lengths": jnp.asarray(lens)}, jc)
        logits, fed = [np.asarray(lj)], []
        for _ in range(steps):
            fed.append(np.asarray(jnp.argmax(logits[-1], -1), np.int32))
            lj, jc = decode(jp, jnp.asarray(fed[-1]), jc)
            logits.append(np.asarray(lj))
    return logits, fed, jax.tree.map(np.asarray, jc)


def _run_port(cfg, params, toks, lens, pt, fed):
    """The port on the same prompts, teacher-forced with JAX's tokens."""
    cache = lm.init_paged_cache(cfg, len(lens), 32, page_size=4, device="cpu")
    cache["page_table"].copy_(torch.from_numpy(pt))
    lt, cache = lm.paged_prefill(params, {"tokens": torch.from_numpy(toks),
                                          "lengths": torch.from_numpy(lens)},
                                 cfg, cache)
    logits = [lt.numpy()]
    for tok in fed:
        lt, cache = lm.decode_step(params, torch.from_numpy(tok.copy()), cache,
                                   cfg)
        logits.append(lt.numpy())
    return logits, interop.to_numpy(cache)


# XLA on the CPU contracts a * b + c into FMAs where the port rounds twice,
# so an activation can land on the other side of a quantizer's rounding
# boundary: one code moves by one step and later layers / steps carry the
# difference.  A step that is not tight is held to a few such flips at
# SMOKE width; without a flip a step is tight.
FLIP_TOL = 0.1


def _hold(got_logits, want_logits, got_cache, want_cache, stats):
    """Per step: logits within FLIP_TOL of their max, tight (TOL) counted;
    greedy tokens equal wherever JAX's top-2 margin exceeds the difference.
    Tables and positions exact; pool codes equal but for a 1% of flips."""
    for gl, wl in zip(got_logits, want_logits):
        err = np.abs(gl - wl).max(axis=-1)                  # per row
        rel = err.max() / np.abs(wl).max()
        assert rel <= FLIP_TOL, rel
        stats["tight"] += int(rel <= TOL)
        stats["steps"] += 1
        top2 = np.sort(wl[:, 0], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * err[:, 0]
        np.testing.assert_array_equal(gl[:, 0].argmax(-1)[clear],
                                      wl[:, 0].argmax(-1)[clear])
    for key in ("pos", "page_table"):
        np.testing.assert_array_equal(got_cache[key], want_cache[key])
    for key in ("k_pages", "v_pages"):
        g, w = got_cache["units"]["b0"][key], want_cache["units"]["b0"][key]
        assert g.dtype == w.dtype
        assert (g != w).mean() <= 1e-2
        stats["flips"] += int((g != w).sum())
    for key in ("k_scale", "v_scale", "page_k_scale", "page_v_scale"):
        np.testing.assert_allclose(got_cache["units"]["b0"][key],
                                   want_cache["units"]["b0"][key],
                                   rtol=1e-2)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_prefill_and_decode_track_jax(kv_bits):
    """SMOKE-width ragged paged prefill + 6 decode steps, three seeds, both
    port backends, against the JAX model's XLA paged path — the ref oracle
    at bk = page_size (module docstring for what is held how).  At
    kv_bits=4 the reference's own Pallas path departs from this XLA path
    (tests/test_paged_decode.py, ROADMAP queue 3); the port follows XLA."""
    jcfg, jp = _jax_model(kv_bits)
    ports = {b: _port(jp, kv_bits, b) for b in ("torch", "cuda")}
    stats = dict(tight=0, steps=0, flips=0)
    pt = np.arange(3 * 8, dtype=np.int32).reshape(3, 8)
    lens = np.array([12, 7, 3], np.int32)
    for seed in range(3):
        toks = np.random.RandomState(seed).randint(0, 64, (3, 12)) \
            .astype(np.int32)
        want, fed, wcache = _run_jax(jcfg, jp, toks, lens, pt, 6)
        for cfg, params in ports.values():
            got, gcache = _run_port(cfg, params, toks, lens, pt, fed)
            _hold(got, want, gcache, wcache, stats)
            assert gcache["pos"].tolist() == [18, 13, 9]
    # no systematic drift: most steps are tight to the last bits
    assert stats["tight"] >= 0.5 * stats["steps"], stats


# ---------------------------------------------------------------------------
# The five bitwise invariants, inside the port
# ---------------------------------------------------------------------------

def _model(kv_bits, backend):
    """The port's config and the JAX package's weights (through interop)."""
    return _port(_jax_model(kv_bits)[1], kv_bits, backend)


KW = dict(batch_size=3, max_len=48, page_size=8, prefill_buckets=(16, 32),
          audit_every=1)


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, n).astype(np.int32) for n in lens]


def _serve(cfg, params, prompts, max_new=5, **kw):
    eng = PagedEngine(cfg, params, **{**KW, **kw})
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert all(r.status == "done" for r in reqs)
    assert eng.audit() == []
    return [r.tokens for r in reqs], eng


BACKENDS_KV = [(b, kv) for b in ("torch", "cuda") for kv in (8, 4)]


@pytest.mark.parametrize("backend,kv_bits", BACKENDS_KV)
def test_invariant_solo_vs_batch_and_admission_order(backend, kv_bits):
    """A batch row equals the same sequence run solo, and a batched
    admission (one prefill for the burst) equals one-at-a-time admission."""
    cfg, params = _model(kv_bits, backend)
    prompts = _prompts([13, 7, 10])
    batched, eng = _serve(cfg, params, prompts)
    assert eng.prefill_calls == 1                     # one burst, one launch
    for p, toks in zip(prompts, batched):
        solo, _ = _serve(cfg, params, [p])
        assert solo[0] == toks
    eng = PagedEngine(cfg, params, **KW)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    for r in reqs:                                    # one admission a step
        eng.submit(r)
        eng.step()
    while eng.step():
        pass
    assert eng.prefill_calls == 3
    assert [r.tokens for r in reqs] == batched


@pytest.mark.parametrize("backend,kv_bits", BACKENDS_KV)
def test_invariant_chunked_vs_one_shot_prefill(backend, kv_bits):
    """Chunking is invisible in the tokens.  A prompt whose cut plan is one
    chunk serves the same through the chunked (PREFILLING, budgeted) path
    as through the one-shot path; multi-chunk prompts packed under a token
    budget serve the same as each request alone on the same cut plan (the
    plan, not the schedule, fixes every page's scale grid)."""
    cfg, params = _model(kv_bits, backend)
    short = _prompts([13, 7, 10], seed=1)
    one_shot, _ = _serve(cfg, params, short)
    single, eng = _serve(cfg, params, short, prefill_chunk=16,
                         prefill_budget=16)
    assert eng.prefill_chunks == 3
    assert single == one_shot
    long = _prompts([29, 18, 9], seed=1)
    packed, eng = _serve(cfg, params, long, prefill_chunk=8,
                         prefill_budget=16)
    assert eng.prefill_chunks > eng.prefill_calls
    for p, toks in zip(long, packed):
        solo, _ = _serve(cfg, params, [p], prefill_chunk=8)
        assert solo[0] == toks


@pytest.mark.parametrize("backend,kv_bits", BACKENDS_KV)
def test_invariant_shared_vs_private_prefix(backend, kv_bits):
    cfg, params = _model(kv_bits, backend)
    rng = np.random.RandomState(2)
    prefix = rng.randint(0, 64, 12).astype(np.int32)   # ends mid-page: CoW
    tails = [rng.randint(0, 64, n).astype(np.int32) for n in (5, 3)]
    eng = PagedEngine(cfg, params, **KW)
    reqs = [Request(rid=i, prompt=np.concatenate([prefix, tl]),
                    max_new_tokens=4, prefix_len=12)
            for i, tl in enumerate(tails)]
    eng.run(reqs)
    assert eng.prefix_prefills == 1 and eng.shared_prefix_hits == 1
    assert dispatch.STATS["cow_page_copies"] >= 1
    assert eng.audit() == []
    for r in reqs:
        solo = PagedEngine(cfg, params, **KW)
        probe = Request(rid=9, prompt=r.prompt, max_new_tokens=4,
                        prefix_len=12)
        solo.run([probe])
        assert probe.tokens == r.tokens


@pytest.mark.parametrize("backend,kv_bits", BACKENDS_KV)
def test_invariant_resumed_vs_uninterrupted(backend, kv_bits):
    cfg, params = _model(kv_bits, backend)
    vic_prompt, hi_prompt = _prompts([16, 16], seed=3)
    kw = dict(batch_size=2, max_len=64, page_size=8, prefill_buckets=(32,),
              audit_every=1)
    base, _ = _serve(cfg, params, [vic_prompt], max_new=8, **kw)
    # 4 pages hold exactly one (16 + 8) / 8 request: admitting the
    # high-priority one preempts the victim mid-flight.
    eng = PagedEngine(cfg, params, **{**kw, "num_pages": 4})
    victim = Request(rid=1, prompt=vic_prompt, max_new_tokens=8)
    eng.submit(victim)
    for _ in range(4):
        eng.step()
    assert 2 <= len(victim.tokens) < 8
    hi = Request(rid=2, prompt=hi_prompt, max_new_tokens=2, priority=5)
    eng.submit(hi)
    while eng.step():
        pass
    assert eng.preempt_count >= 1 and eng.resume_count >= 1
    assert victim.done and hi.done and eng.violations == []
    assert victim.tokens == base[0]
    assert eng.alloc.free_count == eng.num_pages


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_write_prefill_matches_jax_and_loop_oracle(kv_bits):
    """The ragged prefill scatter: codes, per-sequence and per-page scales
    EQUAL to the JAX package's on the same float keys/values, and the pools
    equal to the loop oracle ``ref.ragged_write_ref`` on every non-trash
    page (pads and unallocated positions go to the trash page)."""
    from repro.core.quant import qrange
    from repro_torch.kernels import ref
    rng = np.random.RandomState(kv_bits)
    b, h, s, d, ps, maxp = 3, 2, 10, 8, 4, 4
    k = (rng.randn(b, h, s, d) * rng.uniform(0.5, 3, (b, 1, 1, 1))) \
        .astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    lens = np.array([10, 6, 2], np.int32)
    pt = rng.permutation(12).reshape(b, maxp).astype(np.int32)
    pt[2, 1:] = -1
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    dk = d // 2 if kv_bits == 4 else d
    dt = np.uint8 if kv_bits == 4 else np.int8
    pool = lambda: np.zeros((13, h, ps, dk), dt)
    scales = lambda n: np.ones((n,), np.float32)
    cache = {"k_pages": pool(), "v_pages": pool(), "k_scale": scales(b),
             "v_scale": scales(b), "page_k_scale": scales(13),
             "page_v_scale": scales(13)}
    qj = JQuantConfig(kv_bits=kv_bits, mode="int")
    qt = QuantConfig(kv_bits=kv_bits, mode="int")
    jc = jax.tree.map(np.asarray, jlm._paged_write_prefill(
        jax.tree.map(jnp.asarray, cache), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos), jnp.asarray(lens), jnp.asarray(pt), "int", qj))
    tc = interop.to_numpy(lm._paged_write_prefill(
        interop.to_torch(cache, "cpu"), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(pos.copy()),
        torch.from_numpy(lens), torch.from_numpy(pt), "int", qt))
    for key in cache:
        np.testing.assert_array_equal(tc[key][:12], jc[key][:12], key)
    qmin, qmax = qrange(4 if kv_bits == 4 else 8)
    kq = np.clip(np.round(k / tc["k_scale"][:, None, None, None]), qmin,
                 qmax).astype(np.int8)
    want = ref.ragged_write_ref(np.zeros((13, h, ps, d), np.int8), kq, lens,
                                pt)
    got = tc["k_pages"]
    if kv_bits == 4:
        got = unpack_int4(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(got[:12], want[:12])
