"""Front-to-back alpha blending in log-transmittance form.

Counterpart of `sparse_view_3dgs_pack_tpu/ops/blending.py`. With alphas
sorted front to back:

    s_i      = Σ_{j<=i} log(1-α_j)                (inclusive cumsum)
    w_i      = α_i · exp(s_i - log(1-α_i)) · [not done at i]
    done at i = some j <= i has s_j < log(1e-4)    (sticky stop)

which is the CUDA loop (`forward.cu:323-383`) with its α<1/255 skip, its
α≤0.99 clamp and its T<1e-4 stop.
"""

from __future__ import annotations

import math

import torch

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
LOG_T_EPS = math.log(T_EPS)


def alpha_from_power(power: torch.Tensor,
                     opacity: torch.Tensor) -> torch.Tensor:
    """α = min(0.99, opacity·exp(power)); zero where power>0 or α<1/255.
    exp is taken on min(power, 0) so masked entries stay finite."""
    alpha = torch.clamp(opacity * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    return torch.where((power > 0.0) | (alpha < ALPHA_EPS),
                       torch.zeros_like(alpha), alpha)


def blend_weights(alphas: torch.Tensor, dim: int = -1):
    """Compositing weights for depth-sorted alphas along `dim`.
    Returns (weights, log_T_final)."""
    log1m = torch.log1p(-alphas)
    s_incl = torch.cumsum(log1m, dim=dim)
    s_excl = s_incl - log1m
    crossed = s_incl < LOG_T_EPS
    done = torch.cumsum(crossed.to(torch.int32), dim=dim) > 0
    contribute = ~done
    weights = alphas * torch.exp(s_excl) * contribute
    log_t_final = torch.sum(torch.where(contribute, log1m,
                                        torch.zeros_like(log1m)), dim=dim)
    return weights, log_t_final
