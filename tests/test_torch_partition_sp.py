"""The residual's sequence split (Megatron-SP, ``Rules.seq_tp``) on
rank-local trees, in serving: ``distributed/partition.py`` under
``Rules(partitioned=True, seq_tp=("model",))``.

Four gloo ranks (``tests/_torch_dist_util.py rank sp``) serve the SMOKE
configs of Qwen2.5 (kv 2: attention split at model 2, whole at model 4),
Llama-4-Scout (top-1 MoE with a shared expert), RecurrentGemma-9B (the
RG-LRU split by d_rnn, its one-KV-head local attention whole) and
Mamba2-130M (the SSD mixer whole) in int mode on the (data, model) meshes
(1, 4) and (2, 2): ``prefill`` of 4 x 32 tokens (m divides S: the
residual splits) and of 4 x 31 (it stays whole), then 4 free-running
greedy ring steps (S = 1: whole), each run with and without ``seq_tp``,
while a JAX subprocess (``_torch_dist_util.py jaxsp``, 8 host devices)
runs the reference's own ``seq_tp`` program.  Held:

- every rank's logits at every step, the fed tokens and its cache shard
  (codes, scales, recurrent states, ``pos``) bitwise equal to the same
  partitioned run without ``seq_tp`` (integer sums are exact in any
  order, and everything else acts per row); every row-parallel product
  on the int32 accumulator path in both; where m divides S the split ran
  (a reduce-scatter where a row-parallel K splits, the normed stream's
  all-gathers), and the whole run's bytes sent and result bytes, beside
  the run without it, equal ``chip_smoke.sp_run_wire_analytic``'s count
  (each layer's, below, and the final norm's gather); where it does not
  the run sent what the run without it sent;
- layer 0's bytes: what the split changes in the bytes a rank sends
  (``collectives.WIRE``) and in the exchanges' result bytes (``RESULT``)
  equal to ``chip_smoke.sp_wire_analytic``'s count: per gather of the
  normed stream (m - 1) x its chunk, per row-parallel product with a
  split K a reduce-scatter of its 4-byte sums ((m - 1) / m of them) in
  place of their all-reduce (2 (m - 1) / m);
- ``collectives.reduce_scatter_dim`` on int32 sums past 2^24 equal to the
  sum exactly (an f32 reduce would round them);
- the refusals: ``seq_tp`` with ``int_bf16_reduce`` or ``moe_a2a``
  (``NotImplementedError`` naming its ROADMAP line), and over an axis
  other than "model" (``ValueError``);
- Qwen2.5 SMOKE at 2 layers on JAX's tree, under ``seq_tp`` on both
  meshes, against the reference's ``jax.jit`` run under
  ``Rules(seq_tp=("model",))`` on a (1, 4) host mesh: greedy tokens
  equal, and the logits within FLIP_TOL of their max, the bound
  ``tests/test_torch_partition.py`` holds the port's one-rank run to
  against JAX (XLA contracts FMAs where the port rounds twice, so an
  activation code can move at a rounding edge).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import _torch_dist_util as util  # noqa: E402
from chip_smoke import (analytic_flat, sp_run_wire_analytic,  # noqa: E402
                        sp_splits)

from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

torch.set_num_threads(1)

JOIN_S = 240
FLIP_TOL = 0.1


@pytest.fixture(autouse=True)
def _restore_stats():
    """The dispatch STATS are process-global: put them back."""
    snap = dispatch.snapshot()
    yield
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' outputs, the reference's arrays)."""
    d = tmp_path_factory.mktemp("sp")
    ref = d / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    log = open(d / "jax.log", "w")
    jax_proc = subprocess.Popen(
        [sys.executable, util.__file__, "jaxsp", str(ref)], stdout=log,
        stderr=subprocess.STDOUT, env=env)
    try:
        ranks = util.join(util.launch("sp", 4, d, ref), d, "sp", JOIN_S)
    finally:
        try:
            jax_proc.wait(timeout=JOIN_S)
        finally:
            if jax_proc.poll() is None:
                jax_proc.kill()
                jax_proc.wait()
            log.close()
    assert jax_proc.returncode == 0, (d / "jax.log").read_text()[-3000:]
    return ranks, util.load(ref)


def _cases():
    return [(arch, mesh, s) for mesh in util.SP_MESHES
            for arch in util.SP_ARCHS for s in util.SP_PROMPTS]


def _id(case):
    arch, mesh, s = case
    return f"{arch}-{util.mesh_tag(mesh)}-s{s}"


def _row_products(cfg):
    """Row-parallel products of a forward: a layer's wo or w_out (none in
    the SSD mixer) and a dense FFN's or the shared expert's down."""
    from repro_torch.models import lm
    moe = cfg.moe
    ffn = int(cfg.d_ff > 0 and (moe is None or moe.shared_expert))
    return sum(int(k != "ssd") + ffn for k in lm.block_kinds(cfg))


@pytest.mark.parametrize("case", _cases(), ids=_id)
def test_sp_serving_is_bitwise_the_run_without_it(runs, case):
    arch, mesh, s = case
    ranks, _ = runs
    cfg = smoke_config(arch)
    m = util.mesh_tag(mesh)
    base, sp = f"{arch}/{m}/s{s}/base", f"{arch}/{m}/s{s}/sp"
    splits = s % mesh[1] == 0
    for r in ranks:
        for name in ("logits", "fed"):
            np.testing.assert_array_equal(r[f"{sp}/{name}"],
                                          r[f"{base}/{name}"])
        keys = [k[len(base):] for k in r if k.startswith(f"{base}/cache/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(r[sp + k], r[base + k], k)
        want = _row_products(cfg) * (1 + util.SP_STEPS)
        assert r[f"{sp}/acc"] == r[f"{base}/acc"] == want
        wire = {k: float(r[f"{sp}/wire/{k}"]) for k in
                ("all_reduce", "reduce_scatter", "all_gather")}
        wire0 = {k: float(r[f"{base}/wire/{k}"]) for k in wire}
        assert wire0["reduce_scatter"] == 0
        if not splits:
            assert wire == wire0
            continue
        # the normed streams' gathers, and a reduce-scatter exactly where
        # a row-parallel K splits
        assert wire["all_gather"] > wire0["all_gather"]
        assert (wire["reduce_scatter"] > 0) == \
            (sp_splits(cfg, mesh[1]) > 0), wire
        # the whole run's bytes beside the run without the split: each
        # layer's count and the final norm's gather
        got = {k[len(sp) + 1:]: float(v) - float(r[base + k[len(sp):]])
               for k, v in r.items() if k.startswith((f"{sp}/wire/",
                                                      f"{sp}/result/"))}
        got = {k: v for k, v in got.items() if v}
        rows = util.SP_BATCH // mesh[0] * s
        want = analytic_flat(*sp_run_wire_analytic(cfg, mesh[1], rows))
        assert sorted(got) == sorted(want), (got, want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
        assert r[f"{sp}/logits"].shape == (1 + util.SP_STEPS, util.SP_BATCH,
                                            1, cfg.vocab)


@pytest.mark.parametrize("mesh", util.SP_MESHES, ids=util.mesh_tag)
@pytest.mark.parametrize("arch", util.SP_ARCHS)
def test_layer_bytes_equal_the_analytic_count(runs, arch, mesh):
    ranks, _ = runs
    key = f"layerwire/{arch}/{util.mesh_tag(mesh)}"
    for r in ranks:
        got = {k[len(key) + 5:]: float(v) for k, v in r.items()
               if k.startswith(f"{key}/got/")}
        want = {k[len(key) + 6:]: float(v) for k, v in r.items()
                if k.startswith(f"{key}/want/")}
        assert want and sorted(got) == sorted(want), (got, want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
    # the split's gathers at least; the reduce-scatter where a K splits
    assert ("wire/reduce_scatter" in want) == \
        (sp_splits(smoke_config(arch), mesh[1]) > 0)


def test_int32_reduce_scatter_is_exact_past_2_24(runs):
    ranks, _ = runs
    terms = np.stack([util.sp_rs_terms(r) for r in range(4)]).astype(
        np.int64)
    total = terms.sum(axis=0)
    assert total.max() > 1 << 24
    # f32 would not hold these sums: the exact path is what holds them
    assert (total.astype(np.float32).astype(np.int64) != total).any()
    rows = util.SP_RS_ROWS // 4
    for i, r in enumerate(ranks):
        got = r["rs/int32"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, total[i * rows:(i + 1) * rows])


def test_sp_refuses_what_it_does_not_run(runs):
    ranks, _ = runs
    for r in ranks:
        refused = {k: bool(v) for k, v in r.items()
                   if k.startswith("refused/")}
        assert len(refused) == 3 and all(refused.values()), refused


@pytest.mark.parametrize("flags,err", [
    (dict(int_bf16_reduce=True), NotImplementedError),
    (dict(moe_a2a=True), NotImplementedError),
    (dict(seq_tp=("data",)), ValueError)], ids=["bf16red", "a2a", "data"])
def test_sp_rules_are_refused_when_the_rank_is_made(flags, err):
    """The rank's ``Partition`` refuses the combinations, before any
    exchange; the rules without ``seq_tp`` make it."""
    from repro_torch.distributed.sharding import Rules
    rules = Rules(**{"mesh": _Mesh(), "partitioned": True,
                     "seq_tp": ("model",), **flags})
    with pytest.raises(err, match="ROADMAP.md" if err is
                       NotImplementedError else "model"):
        partition.Partition(rules)
    flags.pop("seq_tp", None)
    assert not partition.Partition(Rules(mesh=_Mesh(), partitioned=True,
                                         **flags)).seq


class _Mesh:
    """A stand-in ``DeviceMesh`` of rank 0 on (data 1, model 4): what
    ``Layout.of`` reads."""
    mesh_dim_names = ("data", "model")
    shape = (1, 4)

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("mesh", util.SP_MESHES, ids=util.mesh_tag)
def test_sp_greedy_equals_the_reference_seq_tp_run(runs, mesh):
    ranks, ref = runs
    want_logits, want_fed = ref["logits"], ref["fed"]
    key = f"jax/{util.mesh_tag(mesh)}"
    for r in ranks:
        np.testing.assert_array_equal(r[f"{key}/fed"], want_fed)
        got = r[f"{key}/logits"]
        for s in range(util.SP_STEPS + 1):
            g, w = got[s, :, -1], want_logits[s, :, -1]
            assert np.abs(g - w).max() <= FLIP_TOL * np.abs(w).max(), s
