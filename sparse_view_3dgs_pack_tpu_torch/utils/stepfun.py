"""Step-function sampling for render paths (the numpy members of
`sparse_view_3dgs_pack_tpu/utils/stepfun.py`, reference `FSGS/utils/
stepfun.py`). The JAX module imports `jax.numpy`, so the port keeps its
own copy of what `utils/pose_utils.py` uses: `sample_np` and its helpers,
numpy only."""

from __future__ import annotations

import numpy as np


def integrate_weights_np(w):
    """Exclusive CDF over the last axis, pinned to [0, 1] with the mip-NeRF
    epsilon handling."""
    cw = np.minimum(1, np.cumsum(w[..., :-1], axis=-1))
    shape = cw.shape[:-1] + (1,)
    cw0 = np.concatenate([np.zeros(shape), cw, np.ones(shape)], axis=-1)
    return cw0


def invert_cdf_np(u, t, w_logits):
    """Invert the CDF defined by (t, softmax(w_logits)) at points u."""
    w = np.exp(w_logits - w_logits.max(axis=-1, keepdims=True))
    w = w / w.sum(axis=-1, keepdims=True)
    cw = integrate_weights_np(w)
    t_new = np.interp(u, cw, t)
    return t_new


def sample_np(rand, t, w_logits, num_samples, single_jitter=False,
              deterministic_center=False):
    """Draw samples from a step function (reference `stepfun.py:221-249`)."""
    eps = np.finfo(np.float32).eps
    if not rand:
        if deterministic_center:
            pad = 1 / (2 * num_samples)
            u = np.linspace(pad, 1.0 - pad - eps, num_samples)
        else:
            u = np.linspace(0, 1.0 - eps, num_samples)
    else:
        u_max = eps + (1 - eps) / num_samples
        max_jitter = (1 - u_max) / (num_samples - 1) - eps
        d = 1 if single_jitter else num_samples
        u = (np.linspace(0, 1 - u_max, num_samples)
             + np.random.rand(d) * max_jitter)
    return invert_cdf_np(u, t, w_logits)
