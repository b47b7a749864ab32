"""Post-quantized LayerNorm (paper §IV-C, Fig. 5, Eq. 5), in PyTorch.

Counterpart of ``repro/core/pqln.py``.  The LayerNorm that feeds a
quantizer never needs a division or square root:

    (x - mu)/sigma * gamma + beta > s_k
        <=>  (x - mu) * gamma > (s_k - beta) * sigma
        <=>  sign logic + comparison of squares      (Fig. 5b)

and mu / sigma^2 come from single-pass incremental (Welford) statistics
(Eq. 5).  A per-tensor factor ``c`` the producer left unapplied cancels
(``LN(c * x) == LN(x)``), so the reordered linear's ``dx_bar`` never needs
to be applied before the norm; RMSNorm behaves the same for ``c``.  The
fused kernel of this module's rsqrt form is
:func:`repro_torch.kernels.pq_layernorm.pq_layernorm`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import quant


class Moments(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor


def moments_twopass(x: torch.Tensor, axis: int = -1) -> Moments:
    """Vectorized reference statistics."""
    mean = x.mean(dim=axis, keepdim=True)
    var = (x - mean).square().mean(dim=axis, keepdim=True)
    return Moments(mean, var)


def moments_welford(x: torch.Tensor) -> Moments:
    """Eq. 5 incremental statistics over the last axis, one element at a
    time (the reference's ``lax.scan``)::

        mu_i = mu_{i-1} + (x_i - mu_{i-1}) / i
        M2_i = M2_{i-1} + (x_i - mu_{i-1}) (x_i - mu_i)    (sigma^2 = M2/n)
    """
    n = x.shape[-1]
    mu = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    m2 = torch.zeros_like(mu)
    for i in range(n):
        xi = x[..., i]
        d = xi - mu
        mu = mu + d / float(i + 1)
        m2 = m2 + d * (xi - mu)
    return Moments(mu[..., None], (m2 / n)[..., None])


def pq_layernorm(x: torch.Tensor, gamma, beta, bits: int, delta_q, *,
                 eps: float = 1e-6,
                 pre_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm -> quantize, the rsqrt formulation.  ``pre_scale`` is the
    producer's unapplied per-channel diag(dw); the per-tensor dx_bar needs
    no argument (it cancels).  Returns int8 codes on the signed b-bit grid
    with step ``delta_q``."""
    if pre_scale is not None:
        x = x * pre_scale
    mean, var = moments_twopass(x)
    y = (x - mean) * torch.rsqrt(var + eps) * gamma + beta
    return quant.quantize(y, delta_q, bits)


def pq_layernorm_comparator(x: torch.Tensor, gamma, beta, bits: int,
                            delta_q, *, eps: float = 1e-6,
                            pre_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Fig. 5(b): the division- and sqrt-free comparator (hardware model).

    For each threshold ``s_k = (k - 1/2) delta_q`` decide ``(x - mu) *
    gamma > (s_k - beta) * sigma`` by sign logic and a comparison of
    squares against ``sigma^2``; the code is ``qmin + #{k : true}``.
    Equal to :func:`pq_layernorm` away from threshold ties."""
    if pre_scale is not None:
        x = x * pre_scale
    mean, var = moments_twopass(x)
    var = var + eps
    qmin, qmax = quant.qrange(bits)
    ks = torch.arange(qmin + 1, qmax + 1, dtype=x.dtype, device=x.device)
    s_k = (ks - 0.5) * delta_q                              # 2^b - 1
    lhs_e = ((x - mean) * gamma)[..., None]                 # (..., n, 1)
    rhs_e = s_k - torch.as_tensor(beta)[..., None]          # (n, K)
    rhs_e = rhs_e.expand(*lhs_e.shape[:-1], s_k.shape[0])
    lhs_sq = lhs_e.square()
    rhs_sq = rhs_e.square() * var[..., None]
    cond = torch.where(rhs_e > 0,
                       (lhs_e > 0) & (lhs_sq > rhs_sq),
                       (lhs_e > 0) | (lhs_sq < rhs_sq))
    code = qmin + cond.sum(dim=-1)
    return torch.clamp(code, qmin, qmax).to(quant.STORAGE_DTYPE)


def rmsnorm(x: torch.Tensor, gamma, *, eps: float = 1e-6,
            pre_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm with the same per-tensor-scale cancellation property."""
    if pre_scale is not None:
        x = x * pre_scale
    ms = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


def pq_rmsnorm(x: torch.Tensor, gamma, bits: int, delta_q, *,
               eps: float = 1e-6,
               pre_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm -> quantize."""
    return quant.quantize(rmsnorm(x, gamma, eps=eps, pre_scale=pre_scale),
                          delta_q, bits)
