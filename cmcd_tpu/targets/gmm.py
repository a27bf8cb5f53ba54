"""Two-dimensional Gaussian-mixture targets.

- make_gmm: the "ChallengingTwoDimensionalMixture" (reference
  src/model_handler.py:157-242): 3 anisotropic components, symmetrized by
  logaddexp(f(x), f(flip(x))) - log 2. Normalized, ln Z = 0.
- make_many_gmm: the 40-mode GMM (reference src/model_handler.py:245-284,
  distrax MixtureSameFamily) with means ~ U(-1, 1) * loc_scaling drawn with
  PRNGKey(seed) and per-dim scale softplus(0.1); log-prob floored at -1e4
  -> -inf. Normalized, ln Z = 0.

The reference's per-sample Python-loop sampler for the 3-mode mixture
(src/model_handler.py:204-228) is replaced by a vectorized
categorical-then-normal draw.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as onp
from jax.scipy.special import logsumexp

from cmcd_tpu.distributions import LOG_2PI
from cmcd_tpu.targets.base import Target

# numpy (not jnp) so importing this module never initializes the backend.
_MEANS = onp.array([[3.0, 0.0], [-2.5, 0.0], [2.0, 3.0]])
_COVS = onp.array(
    [
        [[0.7, 0.0], [0.0, 0.05]],
        [[0.7, 0.0], [0.0, 0.05]],
        [[1.0, 0.95], [0.95, 1.0]],
    ]
)


def make_gmm(config=None) -> Target:
    means = jnp.asarray(_MEANS)  # (3, 2)
    chols = jnp.linalg.cholesky(jnp.asarray(_COVS))  # (3, 2, 2)
    log_weights = jnp.log(jnp.ones(3) / 3.0)
    # log-normalizer per component: -log(2pi) - sum log diag(L)
    log_norm = -LOG_2PI - jnp.sum(
        jnp.log(jnp.diagonal(chols, axis1=-2, axis2=-1)), axis=-1
    )

    # Tiny fixed 2x2 solves: precompute L^{-1} once, whiten with an einsum
    # (one batched contraction instead of a per-sample triangular solve).
    inv_chols = jnp.linalg.inv(chols)  # (3, 2, 2)

    def raw_log_density(x):
        """x: (N, 2) -> (N,)."""
        diff = x[:, None, :] - means[None, :, :]  # (N, 3, 2)
        y = jnp.einsum("kij,nkj->nki", inv_chols, diff)
        maha = -0.5 * jnp.sum(y * y, axis=-1)  # (N, 3)
        return logsumexp(maha + log_norm + log_weights, axis=-1)

    def log_prob(x):
        a = raw_log_density(x)
        b = raw_log_density(jnp.flip(x, axis=-1))
        return jnp.logaddexp(a, b) - jnp.log(2.0)

    def sample(key, n):
        k1, k2 = jax.random.split(key)
        # Symmetrized density == mixture over {component} x {flip}.
        comp = jax.random.categorical(key=k1, logits=jnp.zeros(3), shape=(n,))
        eps = jax.random.normal(k2, (n, 2))
        x = means[comp] + jnp.einsum("nij,nj->ni", chols[comp], eps)
        k3, _ = jax.random.split(k2)
        flip = jax.random.bernoulli(k3, 0.5, (n,))
        return jnp.where(flip[:, None], jnp.flip(x, axis=-1), x)

    return Target(name="gmm", dim=2, log_prob=log_prob, sample=sample)


def make_many_gmm(
    n_mixes: int = 40, loc_scaling: float = 40.0, log_var_scaling: float = 0.1, seed: int = 0
) -> Target:
    dim = 2
    key = jax.random.PRNGKey(seed)
    means = (
        jax.random.uniform(shape=(n_mixes, dim), key=key, minval=-1.0, maxval=1.0)
        * loc_scaling
    )
    # Reference quirk kept: scale = softplus(log_var), not exp
    # (src/model_handler.py:265-268).
    scale = jax.nn.softplus(jnp.ones((n_mixes, dim)) * log_var_scaling)
    log_weights = jnp.log(jnp.ones(n_mixes) / n_mixes)

    def log_prob(x):
        """x: (N, 2) -> (N,). Floor at -1e4 -> -inf (reference :277-281)."""
        diff = (x[:, None, :] - means[None]) / scale[None]  # (N, K, 2)
        comp_lp = -0.5 * jnp.sum(diff * diff + LOG_2PI, axis=-1) - jnp.sum(
            jnp.log(scale), axis=-1
        )
        lp = logsumexp(comp_lp + log_weights, axis=-1)
        return jnp.where(lp > -1e4, lp, -jnp.inf)

    def sample(key, n):
        k1, k2 = jax.random.split(key)
        comp = jax.random.categorical(key=k1, logits=jnp.zeros(n_mixes), shape=(n,))
        eps = jax.random.normal(k2, (n, dim))
        return means[comp] + scale[comp] * eps

    return Target(
        name="many_gmm",
        dim=2,
        log_prob=log_prob,
        sample=sample,
        params={
            "n_mixes": n_mixes,
            "loc_scaling": loc_scaling,
            "log_var_scaling": log_var_scaling,
            "seed": seed,
        },
    )
