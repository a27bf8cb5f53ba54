"""Batched elementary distributions.

Batch-first counterparts of the reference's per-chain distribution helpers
(reference: src/vardist/diag_gauss.py, src/momdist.py): `z` is always
`(N, dim)` and log-probs return `(N,)`. That keeps the hot path as large
batched elementwise ops and reductions instead of vmapped scalar programs.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

# Plain Python float: a module-scope jnp constant would initialize the JAX
# backend at import time, which breaks entry points that need to select the
# platform (e.g. the CPU) before first device use (e.g. dryrun_multichip).
LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Diagonal Gaussian variational distribution
# (reference: src/vardist/diag_gauss.py:20-62, src/variationaldist.py)
# ---------------------------------------------------------------------------


def diag_gaussian_init(dim: int, init_sigma: float = 1.0):
    """Params of a mean-field Gaussian: {mean, logdiag}.

    Mirrors reference src/vardist/diag_gauss.py:20-23.
    """
    return {
        "mean": jnp.zeros(dim),
        "logdiag": jnp.ones(dim) * jnp.log(init_sigma),
    }


def diag_gaussian_log_prob(params, z):
    """log q(z) for a batch. z: (N, dim) -> (N,).

    Reference computes this via numpyro Independent(Normal) per chain
    (src/vardist/diag_gauss.py:31-33); here it is one fused batched reduction.
    """
    mean, logdiag = params["mean"], params["logdiag"]
    inv_scale = jnp.exp(-logdiag)
    y = (z - mean) * inv_scale
    return -0.5 * jnp.sum(y * y + LOG_2PI, axis=-1) - jnp.sum(logdiag)


def diag_gaussian_grad_log_prob(params, z):
    """Analytic d/dz log q(z): -(z - mean) / sigma^2. z: (N, dim) -> (N, dim).

    The reference differentiates the log-prob with autodiff inside every SDE
    step (src/mcd_cais.py:24-30); the closed form avoids a transpose pass.
    """
    mean, logdiag = params["mean"], params["logdiag"]
    return -(z - mean) * jnp.exp(-2.0 * logdiag)


def diag_gaussian_sample(key, params, n: int):
    """Reparameterized batch sample: (n, dim).

    Reference: src/vardist/diag_gauss.py:49-62 (per chain); here one draw.
    """
    mean, logdiag = params["mean"], params["logdiag"]
    eps = jax.random.normal(key, (n, mean.shape[0]))
    return mean + jnp.exp(logdiag) * eps


def diag_gaussian_entropy(params):
    """Entropy of the mean-field Gaussian (reference diag_gauss.py:41-46)."""
    logdiag = params["logdiag"]
    dim = logdiag.shape[0]
    return 0.5 * dim * (1.0 + LOG_2PI) + jnp.sum(logdiag)


# ---------------------------------------------------------------------------
# Gaussian transition kernel of the SDE steps
# (reference: src/mcd_utils.py:14-21)
# ---------------------------------------------------------------------------


def kernel_sample(key, mean, scale):
    """x ~ N(mean, scale^2 I). mean: (N, dim); scale scalar or broadcastable."""
    return mean + scale * jax.random.normal(key, mean.shape)


def kernel_log_prob(x, mean, scale):
    """log N(x; mean, scale^2 I) summed over dim. x, mean: (N, dim) -> (N,).

    Reference uses numpyro Independent(Normal) (src/mcd_utils.py:19-21).
    `scale` may be scalar or broadcastable against `x`.
    """
    scale = jnp.asarray(scale)
    y = (x - mean) / scale
    log_scale = jnp.broadcast_to(jnp.log(scale), x.shape)
    return -0.5 * jnp.sum(y * y + LOG_2PI, axis=-1) - jnp.sum(log_scale, axis=-1)


# ---------------------------------------------------------------------------
# Momentum distribution for UHA (reference: src/momdist.py)
# ---------------------------------------------------------------------------


def momentum_init(dim: int):
    """Zero-mean diag Gaussian momentum, parameterized by logscale."""
    return jnp.zeros(dim)


def momentum_sample(key, eta, prev, logscale):
    """Partial momentum refresh (reference src/momdist.py:13-21), batched.

    prev: (N, dim) or None. Returns (N, dim).
    """
    rho_indep = jnp.exp(logscale) * jax.random.normal(key, prev.shape if prev is not None else None)
    if prev is None:
        return rho_indep
    return eta * prev + jnp.sqrt(1.0 - eta**2) * rho_indep


def momentum_sample_fresh(key, logscale, n: int):
    """Fresh momentum draw for n chains: (n, dim)."""
    dim = logscale.shape[0]
    return jnp.exp(logscale) * jax.random.normal(key, (n, dim))


def momentum_log_prob(rho, logscale):
    """log N(rho; 0, exp(logscale)^2) over dim. rho: (N, dim) -> (N,)."""
    y = rho * jnp.exp(-logscale)
    return -0.5 * jnp.sum(y * y + LOG_2PI, axis=-1) - jnp.sum(logscale)


def std_normal_log_prob(x):
    """log N(x; 0, I) summed over last axis: (N, dim) -> (N,)."""
    return -0.5 * jnp.sum(x * x + LOG_2PI, axis=-1)
