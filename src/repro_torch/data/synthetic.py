"""Deterministic synthetic data (no downloads), in PyTorch.

Counterpart of ``repro/data/synthetic.py``, with the same formulas: token
streams follow a Zipfian unigram mixed with an order-2 Markov structure so
LM losses descend; image batches are class-conditional Gaussian blobs so
classification accuracy is learnable.  Each (seed, step, shard) draws from
its own CPU ``torch.Generator`` (mt19937; CUDA's generator is Philox and
would draw other numbers), then the batch moves to ``device``: a batch is
the same on any device, shards are disjoint, and a resumed run replays
it.  The values differ from the reference's threefry streams; tests that
compare the two packages hand JAX's batch across through numpy.
``image_batch``'s translation shifts come from the reference's own
``np.random.RandomState(seed * 100003 + step)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0


def _generator(seed: int, step: int, shard: int = 0) -> torch.Generator:
    """A CPU generator seeded from (seed, step, shard), one stream each."""
    key = np.random.SeedSequence([seed, step, shard]).generate_state(2)
    return torch.Generator().manual_seed(int(key[0]) << 32 | int(key[1]))


def lm_batch(cfg: DataConfig, step: int, *, shard: int = 0,
             n_shards: int = 1, device="cpu") -> dict:
    """One (batch, seq) int32 token batch + next-token labels for
    ``step``."""
    b = cfg.global_batch // n_shards
    gen = _generator(cfg.seed, step, shard)
    # Zipf-ish unigram via exponential transform of uniforms in [1e-6, 1).
    u = torch.rand((b, cfg.seq_len + 1), generator=gen) * (1 - 1e-6) + 1e-6
    base = (torch.exp(-4.0 * u) * cfg.vocab).to(torch.int32) % cfg.vocab
    # Order-2 structure: every 3rd token is a deterministic mix.
    idx = torch.arange(cfg.seq_len + 1)
    mixed = (base + torch.roll(base, 1, -1) * 7
             + torch.roll(base, 2, -1) * 31) % cfg.vocab
    toks = torch.where(idx % 3 == 2, mixed, base)
    noise = torch.rand(toks.shape, generator=gen) < 0.05
    toks = torch.where(noise, base, toks).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def image_batch(step: int, *, batch: int = 32, img: int = 32,
                classes: int = 10, seed: int = 0, shard: int = 0,
                device="cpu") -> dict:
    """Class-conditional blobs: (B, img, img, 3) f32 in [-1, 1] + int64
    labels."""
    gen = _generator(seed, step, shard)
    labels = torch.randint(0, classes, (batch,), generator=gen)
    # Fixed per-class templates (seeded independent of step).
    tgen = torch.Generator().manual_seed(seed + 7919)
    templates = torch.randn((classes, img, img, 3), generator=tgen) * 0.8
    x = templates[labels] + torch.randn((batch, img, img, 3),
                                        generator=gen) * 0.35
    # DeiT-style translation augmentation (static shift; deterministic).
    rs = np.random.RandomState(seed * 100003 + step)
    x = torch.roll(x, (rs.randint(-2, 3), rs.randint(-2, 3)), dims=(1, 2))
    return {"images": torch.tanh(x).to(device), "labels": labels.to(device)}


def host_shard_iterator(cfg: DataConfig, start_step: int, *, shard: int = 0,
                        n_shards: int = 1, device="cpu"):
    """Restartable iterator: resuming from ``start_step`` replays
    identically."""
    step = start_step
    while True:
        yield lm_batch(cfg, step, shard=shard, n_shards=n_shards,
                       device=device)
        step += 1
