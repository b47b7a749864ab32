"""Paged serving of the recurrent families (RecurrentGemma-9B and
Mamba2-130M SMOKE, and the reference engine test's ``("attn", "rglru")``
hybrid) held against the JAX package's engine, with JAX's weights carried
over by ``interop``.

- ``init_paged_cache``: leaf for leaf JAX's (shapes, dtypes, values): page
  pools for attention layers, the ring cache's per-row states for
  recurrent ones; an SSD-only stack has no pool, and ``copy_page`` /
  ``page_scale_pools`` walk it.
- ``admission_prefill`` at width 2 with ragged lengths into rows (2, 0) of
  a 3-row cache: page-pool codes and tables equal to JAX's; scales,
  installed recurrent states and logits within TOL of their max (XLA
  contracts ``a*b + c`` into FMAs and sums einsums in another order where
  the port rounds each step: ``tests/test_torch_recurrent.py`` measures
  the blocks' scans within 1e-6).  JAX's cache after that admission,
  carried over by ``interop``, decodes one step in the port as in JAX.
- ``PagedEngine``: the same tokens as JAX's engine on both port backends
  in each regime (the prompt fills its bucket; it is padded; the prefill
  is chunked under a token budget; a prompt over the largest bucket
  chunks by itself).  Where every prompt fills its bucket, the tokens also
  equal the port's own ring generation.  Elsewhere they need not: the
  reference scans a recurrent state over the pads and starts every chunk
  from a zero state (ROADMAP queue 3), which
  ``test_pads_and_chunks_enter_the_state_as_in_the_reference`` pins.
- Bitwise inside the port: each request of a run with a priority
  preemption, and of fault drill 1 (a page steal, a NaN row, a forced
  fallback step), equals the request served alone; ``shutdown`` returns
  every page.
- A declared prefix is served unshared; the serve CLI serves the two
  SMOKE models and refuses Whisper as the reference's fails on it.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.kernels import dispatch as jdispatch
from repro.launch import engine as jengine
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.core.api import QuantConfig
from repro_torch.kernels import dispatch
from repro_torch.launch import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import PagedEngine, Request, Status
from repro_torch.models import lm
from repro_torch.runtime.faults import FaultEvent, FaultPlan

torch.set_num_threads(1)

ARCHS = ["recurrentgemma-9b", "mamba2-130m", "hybrid"]
# the reference engine test's hybrid (tests/test_engine.py)
HYBRID = dict(name="t", n_layers=2, d_model=48, n_heads=4, kv_heads=2,
              d_ff=96, vocab=64, dtype="float32", q_chunk=16, remat=False,
              block_pattern=("attn", "rglru"), d_rnn=48)
TOL = 1e-5
GEN = 6


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


_MODELS = {}


def _models(arch):
    """JAX config and integerized params (w4, the hybrid w8 as in the
    reference's engine tests); the port's config per backend and the same
    params through interop."""
    if arch not in _MODELS:
        w_bits = 8 if arch == "hybrid" else 4
        jq = JQuantConfig(w_bits=w_bits, a_bits=8, attn_bits=7, kv_bits=8,
                          mode="int")
        if arch == "hybrid":
            jcfg, tcfg, key = jlm.LMConfig(**HYBRID), lm.LMConfig(**HYBRID), 1
        else:
            jcfg, tcfg = jreg.smoke_config(arch), registry.smoke_config(arch)
            key = 0
        jp = j_integerize(jax.jit(lambda k: jlm.init_params(k, jcfg))(
            jax.random.PRNGKey(key)), jq)
        tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
        ports = {b: tcfg.replace(quant=QuantConfig(
            w_bits=w_bits, a_bits=8, attn_bits=7, kv_bits=8, mode="int",
            backend=b)) for b in ("torch", "cuda")}
        _MODELS[arch] = (jcfg.replace(quant=jq), jp, ports, tp)
    return _MODELS[arch]


def _prompts(vocab, lens, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# The paged cache and one admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_paged_cache_leaf_for_leaf(arch):
    jcfg, _, ports, _ = _models(arch)
    want = dict(_leaves(jax.tree.map(np.asarray, jlm.init_paged_cache(
        jcfg, 3, 32, page_size=8))))
    cache = lm.init_paged_cache(ports["torch"], 3, 32, page_size=8,
                                device="cpu")
    got = dict(_leaves(interop.to_numpy(cache)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    kinds = set(lm.block_kinds(jcfg))
    pools = [p for p in got if p.endswith("k_pages")]
    assert bool(pools) == bool(kinds & set(lm.ATTN_KINDS))
    assert any(p.endswith("/h") for p in got)          # a recurrent state
    if not pools:                       # Mamba: tables and pos, no pool
        assert list(lm.page_scale_pools(cache)) == []
        assert lm.copy_page(cache, 0, 1) is cache


ADMIT_ROWS = np.array([2, 0], np.int32)
ADMIT_TABLE = np.array([[4, 9, 2, -1], [7, -1, -1, -1]], np.int32)
_ADMITTED = {}


def _admission(arch):
    """Two ragged prompts (13 and 6 tokens in a bucket of 16) and JAX's
    jitted admission of them into rows (2, 0) of a 3-row cache, pages of
    8; then page 4 copied into page 11 (``copy_page``)."""
    if arch not in _ADMITTED:
        jcfg, jp, _, _ = _models(arch)
        toks = np.zeros((2, 16), np.int32)
        lens = np.array([13, 6], np.int32)
        for i, p in enumerate(_prompts(jcfg.vocab, lens, seed=5)):
            toks[i, :len(p)] = p
        batch = {"tokens": toks, "lengths": lens}
        with jdispatch.use_backend("xla"):
            jl, jc = jax.jit(lambda p, b, c, r, t: jlm.admission_prefill(
                p, b, jcfg, c, r, t))(
                    jp, jax.tree.map(jnp.asarray, batch),
                    jlm.init_paged_cache(jcfg, 3, 32, page_size=8),
                    jnp.asarray(ADMIT_ROWS), jnp.asarray(ADMIT_TABLE))
            jc = jax.jit(lambda c: jlm.copy_page(c, 4, 11))(jc)
        _ADMITTED[arch] = (batch, np.asarray(jl),
                           jax.tree.map(np.asarray, jc))
    return _ADMITTED[arch]


def _assert_cache_close(got, want, what):
    for path, g in _leaves(interop.to_numpy(got)):
        w = want[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        if g.dtype == np.float32:       # states and scales
            assert rel(g, w) <= TOL, (what, path)
        else:                           # codes, tables, pos
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_prefill_ragged_matches_jax(arch):
    _, _, ports, tp = _models(arch)
    batch, jl, jc = _admission(arch)
    want = dict(_leaves(jc))
    for backend, cfg in ports.items():
        cache = lm.init_paged_cache(cfg, 3, 32, page_size=8, device="cpu")
        tl, cache = lm.admission_prefill(
            tp, interop.to_torch(batch, "cpu"), cfg, cache,
            torch.from_numpy(ADMIT_ROWS), torch.from_numpy(ADMIT_TABLE))
        cache = lm.copy_page(cache, 4, 11)
        assert rel(tl.numpy(), jl) <= TOL, backend
        np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))
        _assert_cache_close(cache, want, backend)
        for path, g in _leaves(interop.to_numpy(cache)):
            if path.split("/")[-1] in ("h", "conv", "convs"):
                # installed at rows 2 and 0; row 1 keeps its zeros
                ax = 1 if path.startswith("/units") else 0
                assert np.take(g, 0, axis=ax).any(), path
                assert not np.take(g, 1, axis=ax).any(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_paged_cache_carried_over_decodes_like_jax(arch):
    """JAX's paged cache after the admission, recurrent states included,
    carried over by ``interop`` and given the engine's host tables (rows 2
    and 0 at their prompt ends, row 1 inactive): one decode step in the
    port writes what JAX's writes and gives its logits."""
    jcfg, jp, ports, tp = _models(arch)
    batch, _, jc = _admission(arch)
    table = np.full((3, 4), -1, np.int32)
    table[ADMIT_ROWS] = ADMIT_TABLE
    jc = dict(jc, pos=np.array([6, -1, 13], np.int32), page_table=table)
    tok = np.array([[3], [5], [7]], np.int32)
    with jdispatch.use_backend("xla"):
        jl, jc2 = jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, jcfg))(
            jp, jnp.asarray(tok), jax.tree.map(jnp.asarray, jc))
    want = dict(_leaves(jax.tree.map(np.asarray, jc2)))
    for backend, cfg in ports.items():
        tl, cache = lm.decode_step(tp, torch.from_numpy(tok),
                                   interop.to_torch(jc, "cpu"), cfg)
        assert rel(tl.numpy(), jl) <= TOL, backend
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))
        _assert_cache_close(cache, want, backend)


# ---------------------------------------------------------------------------
# The engine against the reference's
# ---------------------------------------------------------------------------

REGIMES = {
    # every prompt fills its bucket and lands in one chunk
    "fills": (dict(prefill_buckets=(10,)), (10, 10)),
    # ragged prompts right-padded to one bucket
    "padded": (dict(prefill_buckets=(16,)), (10, 7)),
    # page-aligned chunks of 8 under a budget of 8 tokens a step
    "chunked": (dict(prefill_buckets=(16,), prefill_chunk=8,
                     prefill_budget=8), (10, 7)),
    # a prompt over the largest bucket chunks by itself
    "long": (dict(prefill_buckets=(16,)), (21, 7)),
}
ENGINE_KW = dict(batch_size=2, max_len=64, page_size=8, audit_every=1)


def _serve(mod, cfg, params, prompts, **kw):
    eng = mod.PagedEngine(cfg, params, **ENGINE_KW, **kw)
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=GEN)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.status for r in reqs] == ["done"] * len(reqs)
    assert eng.audit() == [] and eng.violations == []
    return eng, [r.tokens for r in reqs]


def _ring(cfg, params, prompt, steps=GEN):
    """The port's ring generation of one prompt: prefill + greedy steps."""
    lg, cache = lm.prefill(params, {"tokens": torch.from_numpy(prompt)[None]},
                           cfg, max_len=len(prompt) + steps)
    out = []
    for _ in range(steps):
        tok = torch.argmax(lg[:, 0], -1).to(torch.int32)[:, None]
        out.append(int(tok))
        lg, cache = lm.decode_step(params, tok, cache, cfg)
    return out


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_reference_engine(arch, regime):
    jcfg, jp, ports, tp = _models(arch)
    kw, lens = REGIMES[regime]
    prompts = _prompts(jcfg.vocab, lens)
    with jdispatch.use_backend("xla"):
        jeng, want = _serve(jengine, jcfg, jp, prompts, **kw)
    for backend, cfg in ports.items():
        dispatch.reset_stats()
        eng, got = _serve(tengine, cfg, tp, prompts, **kw)
        assert got == want, backend
        assert (eng.prefill_calls, eng.prefill_chunks, eng.prefill_tokens,
                eng.step_count) == (jeng.prefill_calls, jeng.prefill_chunks,
                                    jeng.prefill_tokens, jeng.step_count)
        assert dispatch.STATS[f"qlinear_{backend}"] > 0
        if regime == "fills":
            assert got == [_ring(cfg, tp, p) for p in prompts], backend


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_pads_and_chunks_enter_the_state_as_in_the_reference(arch):
    """The reference's own behaviour, reproduced (ROADMAP queue 3): one
    10-token prompt is served as the ring path serves it only when it
    fills its bucket; padded to 16, or prefilled in chunks of 8, the pads
    enter the recurrent state and each chunk starts from a zero state, and
    the tokens part from the ring's."""
    _, _, ports, tp = _models(arch)
    cfg = ports["torch"]
    prompt = _prompts(cfg.vocab, (10,))
    ring = _ring(cfg, tp, prompt[0])
    got = {name: _serve(tengine, cfg, tp, prompt, **kw)[1][0]
           for name, kw in (("fills", dict(prefill_buckets=(10,))),
                            ("padded", dict(prefill_buckets=(16,))),
                            ("chunked", dict(prefill_buckets=(16,),
                                             prefill_chunk=8)))}
    assert got["fills"] == ring
    assert got["padded"] != ring and got["chunked"] != ring


# ---------------------------------------------------------------------------
# Bitwise inside the port: preemption, fault drill 1, shutdown
# ---------------------------------------------------------------------------

DRILL_KW = dict(batch_size=2, max_len=32, page_size=8, prefill_buckets=(16,),
                num_pages=6, audit_every=1, preempt_after_steps=64)
DRILL_LENS = (12, 9, 11)


def _drill(cfg, params, plan=None):
    """Requests 0 and 1 fill the two rows and the six-page pool; at step 2
    request 2 arrives at priority 1 and preempts one of them, which
    resumes by recompute and replay."""
    prompts = _prompts(cfg.vocab, DRILL_LENS, seed=7)
    eng = PagedEngine(cfg, params, fault_plan=plan, **DRILL_KW)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=8, priority=int(i == 2))
            for i, p in enumerate(prompts)]
    for r in reqs[:2]:
        eng.submit(r)
    while eng.step_count < 2:
        eng.step()
    eng.submit(reqs[2])
    while eng.step():
        pass
    return eng, reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_and_fault_drill_equal_the_request_alone(arch):
    _, _, ports, tp = _models(arch)
    # no pinned backend: a forced step's use_backend("torch") takes effect
    cfg = ports["cuda"].replace(quant=ports["cuda"].quant.replace(
        backend=None))
    with dispatch.use_backend("cuda"):
        alone = []
        for p in _prompts(cfg.vocab, DRILL_LENS, seed=7):
            eng = PagedEngine(cfg, tp, **DRILL_KW)
            r = Request(rid=0, prompt=p, max_new_tokens=8)
            eng.run([r])
            alone.append(r.tokens)
        dispatch.reset_stats()
        eng, reqs = _drill(cfg, tp)
        assert eng.preempt_count >= 1 and eng.resume_count >= 1
        plan = FaultPlan(at=[FaultEvent(step=3, steal_pages=2, steal_hold=2),
                             FaultEvent(step=5, nan_row=1),
                             FaultEvent(step=6, force_xla=True)])
        deng, dreqs = _drill(cfg, tp, plan)
    for e, rs in ((eng, reqs), (deng, dreqs)):
        assert [r.status for r in rs] == [Status.DONE] * 3
        assert [r.tokens for r in rs] == alone
        assert e.violations == [] and e.audit() == []
        assert e.alloc.free_count == e.num_pages
    assert dispatch.STATS["quarantined"] == 1
    assert dispatch.STATS["forced_xla_steps"] == 1
    assert deng.resume_count > eng.resume_count


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_shutdown_keeps_partial_streams_and_returns_every_page(arch):
    _, _, ports, tp = _models(arch)
    cfg = ports["torch"]
    eng = PagedEngine(cfg, tp, **{**DRILL_KW, "prefill_chunk": 8})
    reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(_prompts(cfg.vocab, DRILL_LENS, seed=7))]
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    assert eng.audit() == []
    eng.shutdown()
    assert [r.status for r in reqs] == [Status.PREEMPTED] * 3
    assert reqs[0].tokens and reqs[2].error is not None
    assert eng.alloc.free_count == eng.num_pages and eng.audit() == []


# ---------------------------------------------------------------------------
# Prefix sharing and the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_declared_prefix_is_served_unshared(arch):
    jcfg, jp, ports, tp = _models(arch)
    cfg = ports["torch"]
    prompt = _prompts(cfg.vocab, (12,))[0]
    eng = PagedEngine(cfg, tp, **ENGINE_KW)
    jeng = jengine.PagedEngine(jcfg, jp, **ENGINE_KW)
    req = Request(rid=0, prompt=prompt, max_new_tokens=GEN, prefix_len=8)
    assert not eng.sharing_enabled and not jeng.sharing_enabled
    assert eng._effective_prefix(req) == 0
    assert jeng._effective_prefix(jengine.Request(
        rid=0, prompt=prompt, prefix_len=8)) == 0
    eng.run([req])
    assert eng.prefix_registry == {} and eng.prefix_prefills == 0
    plain = Request(rid=1, prompt=prompt, max_new_tokens=GEN)
    PagedEngine(cfg, tp, **ENGINE_KW).run([plain])
    assert req.tokens == plain.tokens


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(argv)
    return json.loads(out.getvalue())


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_serve_cli_serves_the_recurrent_smoke_models(arch):
    report = _cli(["--arch", arch, "--device", "cpu", "--json", "--batch",
                   "2", "--requests", "3", "--prompt-len", "12", "--gen", "4",
                   "--audit-every", "1"])
    assert [s["status"] for s in report["per_seq"]] == ["done"] * 3
    assert [s["gen"] for s in report["per_seq"]] == [4] * 3
    assert report["audit_violations"] == [] and report["rejected"] == 0
    assert report["device"]["platform"] == "cpu"
    assert report["dispatch"]["qlinear_cuda"] > 0
    assert sum(report["kernel_launches"].values()) == 0    # CPU tensors


def test_serve_cli_refuses_whisper_naming_encdec():
    """The reference's CLI fails on Whisper (its ``lm.init_params`` reads
    ``block_pattern``, which an encoder-decoder config lacks); the port's
    refuses before building anything, naming the module that serves it."""
    with pytest.raises(AttributeError, match="block_pattern"):
        jlm.init_params(jax.random.PRNGKey(0),
                        jreg.smoke_config("whisper-large-v3"))
    with pytest.raises(SystemExit, match="models/encdec.py"):
        tserve.main(["--arch", "whisper-large-v3", "--device", "cpu"])
