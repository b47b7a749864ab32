"""The port's distributed layer at world size 4 over gloo, held against the
reference on a 4-device host mesh.

One module-scoped JAX subprocess (8 host devices; the meshes are
``jax.sharding.Mesh`` over the first 4) writes the reference's inputs and
outputs (``tests/_torch_dist_util.py``); four gloo ranks of the port (a
``file://`` store under ``tmp_path``, one thread each, every join under a
timeout) compute the same cases on those inputs, and the elastic round
trip runs in 8 ranks and then in 6.  Held, with tolerances:

- ``_int_row_parallel`` (``dense(..., tp="row")`` under ``int_bf16_reduce``)
  on a (data 2, model 2) and a (model 4) mesh, 2-D and 3-D x, f32 and bf16,
  int8 and nibble-packed weights, with and without bias: both port
  backends bitwise equal and each launching one rank product; against the
  reference run op by op within ONE bf16 ulp (the f32 partials sum in the
  collective's order, not XLA's: a bf16 rounding edge may fall
  differently; none does here); against the compiled reference within one
  ulp for f32 x, and for bf16 x within two ulps of the output's largest
  value (XLA's compiled epilogue multiplies by the bf16 activation scale's
  unrounded f32 value, up to 2^-9 relative, so each rank's partial moves
  by up to 2^-9 of ITS size, which a small sum does not bound);
  on a mesh where each rank is alone on "data" and "model", bit for bit the
  per-tensor-quantized dense product rounded to bf16, bias after;
- the Qwen2.5 SMOKE int prefill and 4 ring decode steps under
  ``Rules(batch=("data",), mesh, int_bf16_reduce=True, moe_a2a=True)``,
  teacher-forced on the reference's tokens: logits within TOL of their max
  every step, greedy tokens equal, 2 row-parallel products a layer a
  forward and no plain dispatch;
- the Phi-3.5-MoE SMOKE int forward through ``moe_ffn_a2a``: logits
  within TOL, the mesh-averaged ``lb_loss`` within TOL;
- the reference test's float all-to-all (8 experts, top-2) with gradients
  of ``sum(y ** 2)``, with and without ``expert_fsdp``: y within TOL of
  the reference's a2a and dense outputs, every gradient (each rank's, the
  full one) within TOL, and the integerized experts' output within TOL;
- ``compress_psum``: codes equal but for flips at a rounding edge (XLA
  divides by a reciprocal under ``jit``), means equal where every rank's
  code agrees, the error feedback within one grid step, and within two f32
  ulps of the largest code's value of the reference's where the codes agree
  (XLA contracts ``gf - q * scale`` into one FMA);
- ``pipeline_forward`` (4 stages, 8 microbatches) within TOL;
- ``best_mesh`` / ``reshard_to``: 8 -> (4, 2), 6 -> (3, 2), every leaf's
  local shape equal to the reference's shard shape, the tree round-tripped
  bitwise.

Replicated outputs are equal on every rank.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_util as util  # noqa: E402

from repro_torch.core import integerize, quant  # noqa: E402
from repro_torch.core.api import QuantConfig, as_qlinear  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-6
BF16_ULP = 2.0 ** -7           # one bf16 ulp is at most this share of |v|
JOIN_S = 240


def _launch(job, world, d, ref):
    return util.launch(job, world, d, ref)


def _join(procs, d, job):
    return util.join(procs, d, job, JOIN_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    ref = d / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, util.__file__, "jax", str(ref)],
                       capture_output=True, text=True, env=env,
                       timeout=JOIN_S)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    # one launch at a time: the suite's other workers share the cores
    out = {"main": _join(_launch("main", 4, d, ref), d, "main"),
           "e8": _join(_launch("elastic8", 8, d, ref), d, "elastic8")}
    out["e6"] = _join(_launch("elastic6", 6, d, ref), d, "elastic6")
    out["ref"] = util.load(ref)
    return out


def _get(d, key):
    """An array saved under ``key`` or, widened from bf16, ``key@bf16``."""
    return d[key] if key in d else d[key + "@bf16"]


def _close(got, want, tol=TOL):
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _ulps(got, want, bias, n):
    """|got - want| within n bf16 ulps of the value (bias included)."""
    tol = n * BF16_ULP * (np.abs(want) + np.abs(bias)) + 1e-6
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("case", util.ROW_CASES, ids=lambda c: c[0])
def test_row_parallel_matches_reference(runs, case):
    name, mesh, _, dtype, _, bias = case
    o, ref = runs["main"][0], runs["ref"]
    cuda, plain = o[f"row/{name}/{mesh}/cuda"], o[f"row/{name}/{mesh}/torch"]
    np.testing.assert_array_equal(cuda, plain)
    assert o[f"row/{name}/{mesh}/cuda/calls"] == 1
    assert o[f"row/{name}/{mesh}/torch/calls"] == 1
    b = _get(ref, f"row/{name}/p/b") if bias else 0.0
    _ulps(cuda, _get(ref, f"row/{name}/y"), b, 1)
    want = _get(ref, f"row/{name}/y_jit")
    if dtype == "bfloat16":
        assert np.abs(cuda - want).max() <= 2 * BF16_ULP * np.abs(want).max()
    else:
        _ulps(cuda, want, b, 1)


@pytest.mark.parametrize("case", util.ROW_CASES, ids=lambda c: c[0])
def test_row_parallel_alone_is_per_tensor_dense(runs, case):
    """Each rank alone on "data" and "model": the shard body is the dense
    integer product on one per-tensor grid, rounded to bf16, bias after."""
    name, _, _, dtype, packed, bias = case
    ref = runs["ref"]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = torch.from_numpy(_get(ref, f"row/{name}/x")).to(tdt)
    p = {"w_q": torch.from_numpy(ref[f"row/{name}/p/w_q"]),
         "w_scale": torch.from_numpy(ref[f"row/{name}/p/w_scale"])}
    qc = QuantConfig(w_bits=4, a_bits=8, mode="int")
    xq = quant.quantize_tensor(x, qc.a_bits)
    y = integerize.int_linear(xq, as_qlinear(p, qc))
    y = y.to(torch.bfloat16).to(tdt)
    if bias:
        y = y + torch.from_numpy(_get(ref, f"row/{name}/p/b")).to(tdt)
    for r, o in enumerate(runs["main"]):
        np.testing.assert_array_equal(o[f"row/{name}/solo/cuda"],
                                      y.float().numpy(), err_msg=f"rank {r}")
        np.testing.assert_array_equal(o[f"row/{name}/solo/torch"],
                                      y.float().numpy(), err_msg=f"rank {r}")


def test_ranks_hold_the_same_replicated_outputs(runs):
    o = runs["main"]
    for key in o[0]:
        if key.startswith("psum/"):
            continue                   # each rank's own gradients
        for r in (1, 2, 3):
            np.testing.assert_array_equal(o[r][key], o[0][key],
                                          err_msg=f"{key} rank {r}")


def test_qwen_prefill_and_ring_decode_on_the_mesh(runs):
    o, ref = runs["main"][0], runs["ref"]
    fed = ref["qwen/fed"]
    for i in range(util.LM_STEPS + 1):
        got, want = o[f"qwen/logits{i}"], ref[f"qwen/logits{i}"]
        _close(got, want)
        if i < util.LM_STEPS:
            np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                          fed[i][:, 0])
    n_layers = 4                      # Qwen2.5 SMOKE
    assert o["qwen/row_calls"] == 2 * n_layers * (util.LM_STEPS + 1)
    assert o["qwen/plain_calls"] == 0


def test_moe_a2a_int_forward_on_the_mesh(runs):
    o, ref = runs["main"][0], runs["ref"]
    _close(o["moe/logits"], ref["moe/logits"])
    _close(o["moe/aux"], ref["moe/aux"])
    # 4 SMOKE layers x (gate, up, down), each on the rank's local experts
    assert o["moe/qexpert_calls"] == 12


@pytest.mark.parametrize("fsdp", [0, 1])
def test_moe_a2a_with_gradients(runs, fsdp):
    """Float y and every gradient (each rank holds the full one), and the
    int forward, with and without ``expert_fsdp``."""
    o, ref = runs["main"][0], runs["ref"]
    tag = f"a2a/fsdp{fsdp}"
    _close(o[f"{tag}/y"], ref[f"{tag}/y"])
    _close(o[f"{tag}/y"], ref["a2a/y_dense"])
    _close(o[f"{tag}/lb"], ref[f"{tag}/lb"])
    _close(o[f"{tag}/yq"], ref[f"{tag}/yq"])
    grads = [k for k in o if k.startswith(f"{tag}/grad/")]
    assert sorted(grads) == sorted(k for k in ref
                                   if k.startswith(f"{tag}/grad/"))
    assert len(grads) == 4                  # router, experts gate, up, down
    for k in grads:
        assert np.isfinite(o[k]).all()
        _close(o[k], ref[k])


def test_compress_psum_codes_and_means(runs):
    ref, outs = runs["ref"], runs["main"]
    for leaf in ("w", "v"):
        g, e = ref[f"psum/g/{leaf}"], ref[f"psum/e/{leaf}"]
        gf = g + e                                  # (ranks, ...)
        scale = np.float32(max(np.abs(gf).max(), 1e-12) / np.float32(127))
        want_q = np.rint((gf - ref[f"psum/err/{leaf}"]) / scale)
        got_q = np.stack([np.rint((gf[r] - o[f"psum/err/{leaf}"]) / scale)
                          for r, o in enumerate(outs)])
        flip = want_q != got_q
        edge = np.abs(np.abs(gf / scale - np.trunc(gf / scale)) - 0.5) < 1e-3
        assert np.all(edge[flip]), np.argwhere(flip & ~edge)
        assert np.abs(want_q - got_q).max() <= 1
        agree = ~flip.any(axis=0)
        for r, o in enumerate(outs):
            want = ref[f"psum/mean/{leaf}"][r]
            np.testing.assert_allclose(o[f"psum/mean/{leaf}"][agree],
                                       want[agree], rtol=TOL, atol=0)
            # the error feedback: within one grid step, as the reference's
            assert np.abs(o[f"psum/err/{leaf}"]).max() <= scale * 1.01
            ok = ~flip[r]
            eps = np.finfo(np.float32).eps
            np.testing.assert_allclose(o[f"psum/err/{leaf}"][ok],
                                       ref[f"psum/err/{leaf}"][r][ok],
                                       rtol=0, atol=2 * eps * 127 * scale)


def test_pipeline_matches_reference(runs):
    for o in runs["main"]:
        _close(o["pipe/out"], runs["ref"]["pipe/out"])


def test_elastic_remesh_8_to_6(runs):
    ref = runs["ref"]
    params = {k[len("elastic/params/"):]: v for k, v in ref.items()
              if k.startswith("elastic/params/")}
    for n, outs in ((8, runs["e8"]), (6, runs["e6"])):
        assert tuple(ref[f"elastic/mesh{n}"]) == {8: (4, 2), 6: (3, 2)}[n]
        for o in outs:
            assert tuple(o["mesh"]) == tuple(ref[f"elastic/mesh{n}"])
            for k, v in params.items():
                assert tuple(o[f"shard/{k}"]) == \
                    tuple(ref[f"elastic/shard{n}/{k}"]), (n, k)
                np.testing.assert_array_equal(o[f"tree/{k}"], v)
