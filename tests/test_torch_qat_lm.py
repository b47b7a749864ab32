"""The port's causal LM loss (``models/lm.py::lm_loss``) in the QAT graph
(``mode="fake"``) held against the JAX package on numpy inputs.

``lm_loss`` and all its gradients on the Qwen2.5-32B SMOKE config with
``loss_chunk`` below S (two loss chunks), on Phi-3.5-MoE SMOKE (``aux``,
the load-balance loss summed over the layers, equal to JAX's within
1e-6), on Mamba2-130M SMOKE cut to 1 layer (the SSD block, trained through
the chunk loop) and on RecurrentGemma-9B SMOKE cut to 3 layers (one
(rglru, rglru, local) unit: the RG-LRU scan's recursion and windowed
attention), at four seeds each: the loss within 1e-6 and every gradient
within 1e-5 of its leaf's max (f32 sums in other orders).  The port runs
on the fake-quant values and ``exp2_shift`` kinks of JAX's compiled run,
and every code its own forward would have taken otherwise sits at a
rounding edge (``_torch_qat_util.hold_loss``; ``test_torch_qat.py`` says
why).  With ``cfg.remat`` the port's loss and gradients are bitwise those
without recompute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_qat_util import FQ, hold_loss, to_port, torch_grads
from repro.configs import registry as jregistry
from repro.core.api import QuantConfig as JQuantConfig
from repro.kernels import dispatch as jdispatch
from repro.models import lm as jlm
from repro_torch.configs import registry
from repro_torch.core.api import QuantConfig
from repro_torch.kernels import dispatch
from repro_torch.models import lm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


LM_CASES = {  # arch: (n_layers, extra config)
    "qwen2.5-32b": (4, {"loss_chunk": 8}),
    "phi3.5-moe-42b-a6.6b": (4, {}),
    "mamba2-130m": (1, {}),
    "recurrentgemma-9b": (3, {}),
}
SEEDS = (0, 1, 2, 3)


def _lm_configs(arch, n_layers, extra):
    jcfg = jregistry.smoke_config(arch).replace(
        quant=JQuantConfig(**FQ), n_layers=n_layers, **extra)
    tcfg = registry.smoke_config(arch).replace(
        quant=QuantConfig(**FQ), n_layers=n_layers, **extra)
    return jcfg, tcfg


def _lm_case(jcfg, seed, s=16):
    """(JAX params, JAX batch, the port's batch)."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, jcfg.vocab, (2, s)).astype(np.int32)
    labels = rs.randint(0, jcfg.vocab, (2, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    return jlm.init_params(jax.random.PRNGKey(seed), jcfg), jb, tb


@pytest.mark.parametrize("arch", list(LM_CASES))
def test_lm_loss_and_gradients(arch, monkeypatch):
    jcfg, tcfg = _lm_configs(arch, *LM_CASES[arch])
    cases = [_lm_case(jcfg, seed) for seed in SEEDS]
    if arch == "qwen2.5-32b":
        assert tcfg.loss_chunk < cases[0][2]["tokens"].shape[1]
    assert set(lm.block_kinds(tcfg)) == set(tcfg.block_pattern)
    print(hold_loss(monkeypatch, lambda p, b: jlm.lm_loss(p, b, jcfg),
                    lambda p, b: lm.lm_loss(p, b, tcfg), cases,
                    aux=tcfg.moe is not None))


def test_lm_remat_changes_no_number():
    """Recompute in the backward pass (a MoE stack, so ``aux`` rides
    through the recomputed units) gives the same loss and gradients, bit
    for bit."""
    jcfg, tcfg = _lm_configs("phi3.5-moe-42b-a6.6b",
                             *LM_CASES["phi3.5-moe-42b-a6.6b"])
    jp, _, tb = _lm_case(jcfg, 0)
    params = to_port(jp)
    off, on = (torch_grads(lambda p: lm.lm_loss(p, tb, tcfg.replace(
        remat=remat)), params) for remat in (False, True))
    assert torch.equal(off[0], on[0])
    assert torch.equal(off[1]["aux"], on[1]["aux"])
    for path, g in off[2].items():
        assert torch.equal(g, on[2][path]), path
