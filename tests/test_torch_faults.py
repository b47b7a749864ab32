"""Fault injection in the port's serving engine, held against the JAX
package's.

- ``repro_torch.runtime.faults.FaultPlan`` draws the reference's schedule,
  event for event, and ``corrupt_rows`` writes the same NaN rows out of
  place.
- The reference engine's four fault drills (``tests/test_engine.py``:
  NaN quarantine, forced fallback, page steal -> preemption, watchdog
  stalls) run through ``repro.launch.engine`` (XLA path) and the port on
  both backends: tokens, statuses, counters, allocator state and fault
  holds must be EQUAL.  Watchdog counts depend on timing and are only
  asserted, never compared.
- The chaos grammar of ``tests/test_chaos.py`` (submit / cancel / fault /
  step over a six-page pool, plain and chunked prefill): its two
  representative schedules equal JAX's request by request, and a seeded
  subset keeps every chaos invariant inside the port (audit after every
  op, bounded drain, no leaked page, completed streams equal to the
  port's fault-free solo run).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.kernels import dispatch as jdispatch
from repro.launch import engine as jengine
from repro.models import lm as jlm
from repro.runtime import faults as jfaults
from repro.runtime.watchdog import Watchdog as JWatchdog
from repro_torch import interop
from repro_torch.core.api import QuantConfig
from repro_torch.kernels import dispatch
from repro_torch.launch import engine as tengine
from repro_torch.models import lm
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.watchdog import Watchdog

torch.set_num_threads(1)

DIMS = dict(n_layers=2, d_model=48, n_heads=4, kv_heads=2, d_ff=96,
            vocab=64, dtype="float32", q_chunk=16)
COUNTERS = ("step_count", "prefill_calls", "prefill_chunks", "prefill_tokens",
            "prefix_prefills", "shared_prefix_hits", "preempt_count",
            "resume_count")


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


@pytest.fixture(scope="module")
def world():
    """Each package's config and parameters: JAX's (the reference's test
    model) and the port's, with the same parameters and no pinned backend
    (``use_backend`` picks it, so a forced step really switches).  Every
    JAX engine shares one template's jitted decode step, admission prefill
    and XLA twin (as ``tests/test_chaos.py`` does): one trace a shape."""
    qj = JQuantConfig(w_bits=8, a_bits=8, attn_bits=7, mode="int")
    jcfg = jlm.LMConfig(name="t", remat=False, quant=qj, **DIMS)
    jp = j_integerize(jlm.init_params(jax.random.PRNGKey(0),
                                      jcfg.replace(quant=None)), qj)
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    qt = QuantConfig(w_bits=8, a_bits=8, attn_bits=7, mode="int")
    template = jengine.PagedEngine(jcfg, jp, batch_size=2)
    with jdispatch.use_backend("xla"):
        template._step_fallback()
    return {jengine: (jcfg, jp), tengine: (lm.LMConfig(name="t", quant=qt,
                                                        **DIMS), tp),
            "template": template, "ref": {}, "solo": {}}


# ---------------------------------------------------------------------------
# FaultPlan and corrupt_rows
# ---------------------------------------------------------------------------

def _events(plan):
    return {s: dataclasses.asdict(e) for s, e in plan._events.items()}


@pytest.mark.parametrize("seed", [0, 1, 17, 12345])
@pytest.mark.parametrize("mix", [
    dict(p_steal=0.1, p_stall=0.05, p_fallback=0.02, p_nan=0.03),
    dict(p_steal=0.5, steal_pages=3, steal_hold=2, p_nan=0.5),
    dict(p_fallback=1.0, p_stall=0.3, stall_s=0.1),
    dict()])
def test_fault_plan_equals_reference(seed, mix):
    pinned = [dict(step=3, nan_row=5), dict(step=3, force_xla=True),
              dict(step=40, steal_pages=4, steal_hold=1, stall_s=0.5),
              dict(step=41)]
    jp = jfaults.FaultPlan(seed, horizon=512, **mix,
                           at=[jfaults.FaultEvent(**e) for e in pinned])
    tp = tfaults.FaultPlan(seed, horizon=512, **mix,
                           at=[tfaults.FaultEvent(**e) for e in pinned])
    assert _events(tp) == _events(jp)
    assert tp.summary() == jp.summary()
    for step in range(-2, 520):
        je, te = jp.at_step(step), tp.at_step(step)
        assert (je is None) == (te is None)
    extra = dict(step=7, steal_pages=1, steal_hold=9, nan_row=2)
    jp.schedule(jfaults.FaultEvent(**extra))
    tp.schedule(tfaults.FaultEvent(**extra))
    assert _events(tp) == _events(jp) and tp.summary() == jp.summary()
    if mix:
        assert tp.summary()["events"] > len(pinned)


def test_fault_event_merge_equals_reference():
    a = dict(step=2, steal_pages=3, steal_hold=1, stall_s=0.2, nan_row=4)
    b = dict(step=2, steal_pages=1, steal_hold=5, force_xla=True)
    for x, y in ((a, b), (b, a), (a, a), (b, dict(step=2, nan_row=0))):
        want = jfaults.FaultEvent(**x).merge(jfaults.FaultEvent(**y))
        got = tfaults.FaultEvent(**x).merge(tfaults.FaultEvent(**y))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("rows", [[0], [2, 3], [1, 1], []])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corrupt_rows_equals_reference_out_of_place(rows, dtype):
    x = np.random.RandomState(len(rows)).randn(4, 1, 33).astype(np.float32)
    want = np.asarray(jfaults.corrupt_rows(jnp.asarray(x, dtype), rows),
                      np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    before = t.clone()
    got = tfaults.corrupt_rows(t, rows)
    assert got.dtype == t.dtype and got.device == t.device
    assert torch.equal(t, before)                   # input left unchanged
    np.testing.assert_array_equal(np.isnan(got.float().numpy()),
                                  np.isnan(want))
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# The reference engine's four fault drills
# ---------------------------------------------------------------------------

ENGINE_KW = dict(batch_size=2, max_len=64, page_size=8, prefill_buckets=(32,))


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 64, n).astype(np.int32)


def _faults(mod):
    return jfaults if mod is jengine else tfaults


def _engine(mod, world, base=ENGINE_KW, **kw):
    cfg, params = world[mod]
    eng = mod.PagedEngine(cfg, params, **{**base, **kw})
    if mod is jengine:
        t = world["template"]
        eng._step, eng._admit_prefill = t._step, t._admit_prefill
        eng._step_xla = t._step_xla
    return eng


def _serve(mod, world, reqs, **kw):
    eng = _engine(mod, world, **kw)
    made = [mod.Request(rid=r, prompt=p, max_new_tokens=n)
            for r, p, n in reqs]
    eng.run(made)
    return eng, made


def _nan_drill(mod, world):
    base, (a0, b0) = _serve(mod, world, [(0, _prompt(12, 32), 8),
                                         (1, _prompt(9, 33), 8)],
                            audit_every=1)
    f = _faults(mod)
    plan = f.FaultPlan(at=[f.FaultEvent(step=3, nan_row=0)])
    eng, (a, b) = _serve(mod, world, [(0, a0.prompt, 8), (1, b0.prompt, 8)],
                         audit_every=1, fault_plan=plan)
    assert a.tokens == a0.tokens and b.tokens == b0.tokens
    assert a.done and b.done and not a.failed and not b.failed
    return eng, [a, b]


def _forced_drill(mod, world):
    base, (r0,) = _serve(mod, world, [(0, _prompt(11, 34), 6)],
                         audit_every=1)
    f = _faults(mod)
    plan = f.FaultPlan(at=[f.FaultEvent(step=s, force_xla=True)
                           for s in (1, 3)])
    eng, (r,) = _serve(mod, world, [(0, r0.prompt, 6)], audit_every=1,
                       fault_plan=plan)
    assert r.tokens == r0.tokens
    return eng, [r]


def _steal_drill(mod, world):
    kw = dict(num_pages=8, audit_every=1)
    _, (a0,) = _serve(mod, world, [(0, _prompt(14, 35), 8)], **kw)
    _, (b0,) = _serve(mod, world, [(1, _prompt(10, 36), 4)], **kw)
    f = _faults(mod)
    plan = f.FaultPlan(at=[f.FaultEvent(step=2, steal_pages=6,
                                        steal_hold=3)])
    eng = _engine(mod, world, fault_plan=plan, preempt_after_steps=1, **kw)
    a = mod.Request(rid=0, prompt=a0.prompt, max_new_tokens=8)
    eng.submit(a)
    eng.step()
    eng.step()                                  # a runs; the steal lands @2
    b = mod.Request(rid=1, prompt=b0.prompt, max_new_tokens=4)
    eng.submit(b)                               # must squeeze past the hold
    held = []
    while eng.step():
        held = held or [(s, list(p)) for s, p in eng._fault_held]
    assert held                 # min(6, free pages) stolen, then released
    assert a.tokens == a0.tokens and b.tokens == b0.tokens
    assert a.done and b.done and not a.failed and not b.failed
    assert eng._fault_held == []
    assert eng.alloc.free_count == eng.num_pages
    eng.held_at_steal = held
    return eng, [a, b]


def _watchdog_drill(mod, world):
    _serve(mod, world, [(9, _prompt(8, 39), 10)])      # warm (JAX traces)
    f = _faults(mod)
    plan = f.FaultPlan(at=[f.FaultEvent(step=s, stall_s=0.25)
                           for s in (6, 7)])
    wd = (JWatchdog if mod is jengine else Watchdog)(threshold=4.0,
                                                     patience=1)
    eng, (r,) = _serve(mod, world, [(0, _prompt(8, 37), 10)],
                       fault_plan=plan, watchdog=wd)
    assert wd.flags >= 1
    return eng, [r]


DRILLS = {"nan_quarantine": _nan_drill, "forced_fallback": _forced_drill,
          "steal_preemption": _steal_drill, "watchdog": _watchdog_drill}


def _reference(world, name):
    """The JAX engine's run of one drill (XLA path), cached per module."""
    if name not in world["ref"]:
        jdispatch.reset_stats()
        with jdispatch.use_backend("xla"):
            eng, reqs = DRILLS[name](jengine, world)
        world["ref"][name] = (eng, reqs, jdispatch.snapshot())
    return world["ref"][name]


def _per_step_qlinears(world):
    """Linear layers one decode step dispatches (the plain path's count)."""
    cfg, params = world[tengine]
    cache = lm.init_paged_cache(cfg, 1, 16, page_size=8, device="cpu")
    dispatch.reset_stats()
    with dispatch.use_backend("torch"):
        lm.decode_step(params, torch.zeros((1, 1), dtype=torch.int32), cache,
                       cfg)
    n = dispatch.STATS["qlinear_torch"]
    assert dispatch.STATS["attention_paged_torch"] == cfg.n_layers
    return n


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", list(DRILLS))
def test_engine_fault_drill_equals_reference(world, name, backend):
    jeng, jreqs, jstats = _reference(world, name)
    dispatch.reset_stats()
    with dispatch.use_backend(backend):
        teng, treqs = DRILLS[name](tengine, world)
    stats = dispatch.snapshot()
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == jr.tokens, (name, backend, tr.rid)
        assert (tr.status, tr.admitted_step, tr.finished_step,
                tr.preemptions, tr.error) == \
            (jr.status, jr.admitted_step, jr.finished_step, jr.preemptions,
             jr.error), (name, backend, tr.rid)
    for key in COUNTERS:
        assert getattr(teng, key) == getattr(jeng, key), key
    assert teng.alloc.refs == jeng.alloc.refs
    assert teng.alloc.free == jeng.alloc.free
    assert teng._fault_held == jeng._fault_held == []
    np.testing.assert_array_equal(teng.page_table, jeng.page_table)
    np.testing.assert_array_equal(teng.pos, jeng.pos)
    assert teng.audit() == [] and teng.violations == jeng.violations == []
    for key in ("quarantined", "forced_xla_steps", "preemptions", "resumes"):
        assert stats[key] == jstats[key], key
    if name == "steal_preemption":
        assert teng.held_at_steal == jeng.held_at_steal
        assert stats["preemptions"] >= 1
    if name == "nan_quarantine":
        assert stats["quarantined"] == 1 and stats["resumes"] == 1
    if name == "forced_fallback":
        assert stats["forced_xla_steps"] == 2
        # the two forced steps are the only plain dispatches on the kernel
        # route; on the plain route every step is plain
        per_step = _per_step_qlinears(world)
        if backend == "cuda":
            assert stats["qlinear_torch"] == 2 * per_step
            assert stats["attention_paged_torch"] == 2 * DIMS["n_layers"]
        else:
            assert stats["qlinear_cuda"] == stats["attention_paged_cuda"] == 0
    if name == "watchdog":
        assert stats["watchdog_fires"] >= 1


def test_forced_step_selects_the_plain_backend_explicitly(world,
                                                         monkeypatch):
    """Under the plain backend a forced step is selected all the same; a
    model whose QuantConfig pins the kernel route keeps it, as in the
    reference."""
    tcfg, tp = world[tengine]
    seen = []
    real = lm.decode_step

    def spy(*a, **k):
        seen.append(dispatch.get_backend())
        return real(*a, **k)

    monkeypatch.setattr(lm, "decode_step", spy)
    plan = tfaults.FaultPlan(at=[tfaults.FaultEvent(step=1, force_xla=True)])
    for backend in ("torch", "cuda"):
        seen.clear()
        with dispatch.use_backend(backend):
            eng = tengine.PagedEngine(tcfg, tp, fault_plan=plan, **ENGINE_KW)
            eng.run([tengine.Request(rid=0, prompt=_prompt(5, 3),
                                     max_new_tokens=4)])
        assert seen == [backend, "torch", backend], seen
    monkeypatch.undo()
    pinned = tcfg.replace(quant=tcfg.quant.replace(backend="cuda"))
    dispatch.reset_stats()
    with dispatch.use_backend("cuda"):
        eng = tengine.PagedEngine(pinned, tp, fault_plan=plan, **ENGINE_KW)
        eng.run([tengine.Request(rid=0, prompt=_prompt(5, 3),
                                 max_new_tokens=4)])
    assert dispatch.STATS["forced_xla_steps"] == 1
    assert dispatch.STATS["qlinear_torch"] == 0


def test_audit_counts_fault_holds_and_shutdown_releases_them(world):
    tcfg, tp = world[tengine]
    plan = tfaults.FaultPlan(at=[tfaults.FaultEvent(step=1, steal_pages=3,
                                                    steal_hold=50)])
    eng = tengine.PagedEngine(tcfg, tp, audit_every=1, fault_plan=plan,
                              **ENGINE_KW)
    eng.submit(tengine.Request(rid=0, prompt=_prompt(9, 4),
                               max_new_tokens=20))
    for _ in range(3):
        eng.step()
    assert [len(p) for _, p in eng._fault_held] == [3]
    assert eng.audit() == []
    stolen = eng._fault_held[0][1]
    eng._fault_held.clear()                      # a leak the audit must see
    bad = eng.audit(raise_on_fail=False)
    assert any("fault holds" in v for v in bad)
    eng._fault_held.append((51, stolen))
    eng.violations.clear()
    eng.shutdown()
    assert eng._fault_held == []
    assert eng.alloc.free_count == eng.num_pages
    assert eng.audit() == []


# ---------------------------------------------------------------------------
# The chaos grammar (tests/test_chaos.py), in both packages
# ---------------------------------------------------------------------------

STEP_BUDGET = 300
PROMPT_LENS = (5, 9, 14)
MAX_NEW = (3, 5)
CHAOS_KW = dict(batch_size=2, max_len=24, page_size=8, prefill_buckets=(16,),
                num_pages=6)
CHUNKED_KW = {**CHAOS_KW, "prefill_chunk": 8, "prefill_budget": 8}


def _chaos_prompt(pid):
    rng = np.random.RandomState(1000 + pid)
    return rng.randint(0, 64, PROMPT_LENS[pid % len(PROMPT_LENS)]) \
        .astype(np.int32)


def _chaos_engine(mod, world, kind, **kw):
    base = CHUNKED_KW if kind == "chunked" else CHAOS_KW
    return _engine(mod, world, base, audit_every=0, **kw)


def _solo(world, kind, pid, max_new):
    """The port's fault-free run of one chaos request alone, cached."""
    key = (kind, pid, max_new)
    if key not in world["solo"]:
        eng = _chaos_engine(tengine, world, kind)
        req = tengine.Request(rid=-1, prompt=_chaos_prompt(pid),
                              max_new_tokens=max_new)
        eng.run([req])
        assert req.done and not req.failed
        world["solo"][key] = list(req.tokens)
    return world["solo"][key]


def _run_schedule(mod, world, kind, ops, seed):
    """One op sequence of the chaos grammar; ``ops`` are (kind, a, b):
    0 submit, 1 cancel, 2 fault (b mod 4: steal / nan / forced step /
    stall, at the next engine step), 3 run 1 + (b mod 3) steps.  The audit
    holds after every op; the drain is bounded; no page leaks."""
    f = _faults(mod)
    plan = f.FaultPlan(seed=seed)
    eng = _chaos_engine(mod, world, kind, fault_plan=plan,
                        preempt_after_steps=2, backoff_cap=2)
    submitted = []
    for kind, a, b in ops:
        if kind == 0:
            pid, mn = a % 6, MAX_NEW[b % len(MAX_NEW)]
            req = mod.Request(rid=len(submitted), prompt=_chaos_prompt(pid),
                              max_new_tokens=mn, priority=(a + b) % 3)
            submitted.append((req, pid, mn))
            eng.submit(req)
        elif kind == 1 and submitted:
            submitted[a % len(submitted)][0].cancel()
        elif kind == 2:
            ev = f.FaultEvent(step=eng.step_count)
            which = b % 4
            if which == 0:
                ev.steal_pages, ev.steal_hold = 1 + a % 3, 1 + b % 3
            elif which == 1:
                ev.nan_row = a
            elif which == 2:
                ev.force_xla = True
            else:
                ev.stall_s = 0.001
            plan.schedule(ev)
        else:
            for _ in range(1 + b % 3):
                eng.step()
        eng.audit()
    steps = 0
    while eng.step():
        steps += 1
        assert steps < STEP_BUDGET, "engine stopped making progress"
        eng.audit()
    assert eng._fault_held == [] or all(
        s > eng.step_count for s, _ in eng._fault_held)
    eng.shutdown()
    while eng._reclaim_one():
        pass
    assert eng.alloc.free_count == eng.num_pages
    eng.audit()
    return eng, submitted


def _seeded_ops(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(4, 12)
    ops = [(0, int(rng.randint(0, 6)), int(rng.randint(0, 8)))]
    ops += [(int(rng.randint(0, 4)), int(rng.randint(0, 8)),
             int(rng.randint(0, 8))) for _ in range(n)]
    return ops


def _check_against_solo(world, kind, submitted, seed):
    for req, pid, mn in submitted:
        assert req.status in (tengine.Status.DONE, tengine.Status.CANCELLED,
                              tengine.Status.REJECTED,
                              tengine.Status.TIMED_OUT,
                              tengine.Status.PREEMPTED), req.status
        solo = _solo(world, kind, pid, mn)
        if req.status == tengine.Status.DONE:
            assert req.tokens == solo, (seed, req.rid, req.tokens, solo)
        elif req.tokens:
            assert req.tokens == solo[:len(req.tokens)], (seed, req.rid)


# test_chaos.py's two representative schedules, verbatim
REPRESENTATIVE = {
    "plain": [(0, 2, 1), (3, 0, 1), (2, 1, 0), (0, 1, 0), (3, 0, 2),
              (2, 0, 1), (2, 0, 2), (3, 0, 2), (0, 4, 1), (1, 0, 0),
              (3, 0, 2)],
    "chunked": [(0, 2, 1), (3, 0, 0), (2, 1, 0), (0, 5, 0), (3, 0, 0),
                (1, 0, 0), (3, 0, 2), (0, 1, 1), (2, 0, 2), (3, 0, 2)],
}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("kind", list(REPRESENTATIVE))
def test_chaos_representative_case_equals_reference(world, kind, backend):
    ops = REPRESENTATIVE[kind]
    jdispatch.reset_stats()
    with jdispatch.use_backend("xla"):
        jeng, jsub = _run_schedule(jengine, world, kind, ops, seed=0)
    dispatch.reset_stats()
    with dispatch.use_backend(backend):
        teng, tsub = _run_schedule(tengine, world, kind, ops, seed=0)
    for (jr, _, _), (tr, _, _) in zip(jsub, tsub):
        assert tr.tokens == jr.tokens, (kind, tr.rid)
        assert (tr.status, tr.admitted_step, tr.finished_step,
                tr.preemptions, tr.error) == \
            (jr.status, jr.admitted_step, jr.finished_step, jr.preemptions,
             jr.error), (kind, tr.rid)
    for key in COUNTERS:
        assert getattr(teng, key) == getattr(jeng, key), key
    assert teng.alloc.refs == jeng.alloc.refs
    assert teng.alloc.free == jeng.alloc.free
    assert teng.violations == jeng.violations == []
    assert teng.step_count > 0
    if kind == "chunked":
        assert teng.prefill_chunks > teng.prefill_calls
    _check_against_solo(world, kind, tsub, 0)
    for key in ("quarantined", "forced_xla_steps", "preemptions", "resumes",
                "cancelled", "expired", "audit_failures"):
        assert dispatch.STATS[key] == jdispatch.STATS[key], key
    if kind == "plain":
        assert dispatch.STATS["forced_xla_steps"] == 1
        assert dispatch.STATS["quarantined"] == 1


# About 32 plain and 8 chunked seeded sequences, in groups of 8.
@pytest.mark.parametrize("kind,seeds", [
    ("plain", range(0, 8)), ("plain", range(8, 16)),
    ("plain", range(16, 24)), ("plain", range(24, 32)),
    ("chunked", range(0, 8))])
def test_chaos_seeded_sequences_keep_every_invariant(world, kind, seeds):
    preempts = 0
    dispatch.reset_stats()
    with dispatch.use_backend("cuda"):
        for seed in seeds:
            eng, sub = _run_schedule(tengine, world, kind, _seeded_ops(seed),
                                     seed)
            _check_against_solo(world, kind, sub, seed)
            preempts += eng.preempt_count
    assert dispatch.STATS["audit_failures"] == 0
    assert preempts > 0 or kind == "chunked"
