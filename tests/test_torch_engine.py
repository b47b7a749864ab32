"""The port's serving engine and CLI held against the JAX package's.

The same request scripts run through ``repro.launch.engine.PagedEngine``
(XLA path) and ``repro_torch.launch.engine.PagedEngine`` (both backends):
tokens, statuses, admission / prefill / sharing / preemption counters,
allocator state and the host page-table mirrors must be EQUAL, and
``audit()`` clean.  No request carries an EOS id, so scheduling does not
depend on token values.  Also: ``python -m repro_torch.launch.serve`` on
the CPU, and the allocator's invariants against the reference allocator.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.kernels import dispatch as jdispatch
from repro.launch import engine as jengine
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.core.api import QuantConfig
from repro_torch.kernels import dispatch
from repro_torch.launch import engine as tengine
from repro_torch.launch import serve as tserve
from repro_torch.models import lm
from repro_torch.runtime import preemption

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DIMS = dict(n_layers=2, d_model=48, n_heads=4, kv_heads=2, d_ff=96,
            vocab=64, dtype="float32", q_chunk=16)


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def _models(kv_bits):
    qj = JQuantConfig(w_bits=8, a_bits=8, attn_bits=7, kv_bits=kv_bits,
                      mode="int")
    jcfg = jlm.LMConfig(name="t", remat=False, quant=qj, **DIMS)
    jp = jax.jit(lambda key: j_integerize(
        jlm.init_params(key, jcfg.replace(quant=None)), qj))(
            jax.random.PRNGKey(0))
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    ports = {}
    for backend in ("torch", "cuda"):
        qt = QuantConfig(w_bits=8, a_bits=8, attn_bits=7, kv_bits=kv_bits,
                         mode="int", backend=backend)
        ports[backend] = lm.LMConfig(name="t", quant=qt, **DIMS)
    return jcfg, jp, ports, tp


COUNTERS = ("step_count", "prefill_calls", "prefill_chunks", "prefill_tokens",
            "prefix_prefills", "shared_prefix_hits", "preempt_count",
            "resume_count")


def _script(mod, cfg, params):
    """One request script: 5 staggered requests over 3 rows with a shared
    12-token prefix (mid-page: copy-on-write), a 10-page pool, and a late
    high-priority arrival that preempts a running request (a bit-exact
    resume follows).  Returns the engine and its requests."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 64, 12).astype(np.int32)
    eng = mod.PagedEngine(cfg, params, batch_size=3, max_len=48, page_size=8,
                          num_pages=10, prefill_buckets=(16,),
                          audit_every=1, preempt_after_steps=2)
    reqs = []
    for i, n in enumerate((9, 4, 6, 11)):
        tail = rng.randint(0, 64, n).astype(np.int32)
        reqs.append(mod.Request(rid=i, prompt=np.concatenate([prefix, tail]),
                                max_new_tokens=5, prefix_len=12))
        eng.submit(reqs[-1])
    for _ in range(5):
        eng.step()
    late = mod.Request(rid=9, prompt=rng.randint(0, 64, 14).astype(np.int32),
                       max_new_tokens=4, priority=3)
    reqs.append(late)
    eng.submit(late)
    while eng.step():
        pass
    return eng, reqs


def test_same_script_same_tokens_states_and_counters():
    jcfg, jp, ports, tp = _models(kv_bits=4)
    with jdispatch.use_backend("xla"):
        jeng, jreqs = _script(jengine, jcfg, jp)
    assert jeng.preempt_count >= 1 and jeng.shared_prefix_hits >= 1
    for backend, cfg in ports.items():
        dispatch.reset_stats()
        teng, treqs = _script(tengine, cfg, tp)
        for jr, tr in zip(jreqs, treqs):
            assert tr.tokens == jr.tokens, (backend, tr.rid)
            assert (tr.status, tr.admitted_step, tr.finished_step,
                    tr.preemptions, tr.error) == \
                (jr.status, jr.admitted_step, jr.finished_step,
                 jr.preemptions, jr.error), (backend, tr.rid)
        for name in COUNTERS:
            assert getattr(teng, name) == getattr(jeng, name), name
        assert teng.alloc.refs == jeng.alloc.refs
        assert teng.alloc.free == jeng.alloc.free
        np.testing.assert_array_equal(teng.page_table, jeng.page_table)
        np.testing.assert_array_equal(teng.pos, jeng.pos)
        assert sorted(teng.prefix_registry) == sorted(jeng.prefix_registry)
        assert teng.audit() == [] and teng.violations == []
        for key in ("prefill_calls", "prefill_chunks", "prefill_tokens",
                    "preemptions", "resumes"):
            assert dispatch.STATS[key] > 0 or key == "resumes"
        assert dispatch.STATS[f"qlinear_{backend}"] > 0
        assert dispatch.STATS[f"attention_paged_{backend}"] > 0


def test_allocator_matches_reference_allocator():
    rng = np.random.RandomState(0)
    ja, ta = jengine.PageAllocator(12), tengine.PageAllocator(12)
    held = []
    for _ in range(300):
        op = rng.randint(3)
        if op == 0 and ja.free_count:
            n = int(rng.randint(1, ja.free_count + 1))
            pages = ja.alloc(n)
            assert ta.alloc(n) == pages
            held.append(pages)
        elif op == 1 and held:
            pages = held[rng.randint(len(held))]
            ja.share(pages)
            ta.share(pages)
            held.append(list(pages))
        elif held:
            pages = held.pop(rng.randint(len(held)))
            ja.release(pages)
            ta.release(pages)
        assert ta.refs == ja.refs and ta.free == ja.free
        assert ta.check()
    with pytest.raises(RuntimeError):
        ta.release([p for p in range(12) if ta.refs[p] == 0][:1] or [0] * 99)


def _serve_cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--requests", "3", "--prompt-len", "12", "--gen",
         "3", "--page-size", "8", *args],
        capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
        env=env)


def test_serve_cli_json_on_cpu_plain_backend():
    proc = _serve_cli("--backend", "torch", "--json")
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout)
    assert rep["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert rep["backend"] == "torch"
    assert [s["status"] for s in rep["per_seq"]] == ["done"] * 3
    assert rep["kernel_launches"] == {"qmatmul": 0, "qmatmul_acc": 0,
                                      "int_attention_fused": 0,
                                      "int_attention": 0,
                                      "int_paged_decode_attention": 0,
                                      "int_decode_attention": 0,
                                      "pq_layernorm": 0}
    d = rep["dispatch"]
    assert d["qlinear_torch"] > 0 and d["qlinear_cuda"] == 0
    assert d["attention_paged_torch"] > 0 and d["attention_torch"] > 0
    assert rep["audit_violations"] == [] and not rep["preempted"]
    assert rep["prefill_tokens"] == sum(s["prompt_len"]
                                        for s in rep["per_seq"])


def test_serve_main_in_process_restores_signal_handlers(capsys):
    """The CLI's graceful-shutdown drill exits PREEMPTED with partial
    outputs, on the cuda route (plain kernel versions on the CPU), and
    puts back the SIGTERM / SIGUSR1 handlers it installed."""
    before = {s: signal.getsignal(s) for s in preemption.SIGNALS}
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--device", "cpu", "--backend", "cuda", "--batch", "2",
                     "--requests", "3", "--prompt-len", "12", "--gen", "4",
                     "--page-size", "8", "--preempt-after-step", "2",
                     "--json"])
    assert exc.value.code == preemption.PREEMPTED_EXIT_CODE
    assert {s: signal.getsignal(s) for s in preemption.SIGNALS} == before
    assert not preemption.should_stop()
    rep = json.loads(capsys.readouterr().out)
    assert rep["preempted"] and rep["backend"] == "cuda"
    assert {s["status"] for s in rep["per_seq"]} <= {"preempted"}
    assert rep["dispatch"]["qlinear_cuda"] > 0
    assert rep["dispatch"]["qlinear_torch"] == 0
