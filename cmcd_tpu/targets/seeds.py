"""Seeds random-effects GLMM target (26-dim posterior).

Reference: src/models/seeds.py via numpyro's potential_fn
(src/model_handler.py:67-86). Model:
  tau ~ Gamma(0.01, 0.01)
  a_0, a_1, a_2, a_12 ~ N(0, 10)
  b_j ~ N(0, 1/sqrt(tau)),  j = 1..21
  r_j ~ BinomialLogits(a_0 + a_1 X1 + a_2 X2 + a_12 X1 X2 + b_j, N_j)

numpyro works in unconstrained space: tau = exp(u) with log-Jacobian +u.
The flattened layout matches numpyro's ravel_pytree (alphabetical site
order): [a_0, a_1, a_12, a_2, b(21), u_tau]. Expected posterior moments for
validation are in the reference comment (src/models/seeds.py:59-66), e.g.
E[a_0] = -0.5525.
"""

from __future__ import annotations

import numpy as onp
import jax.numpy as jnp
from scipy.special import gammaln

from cmcd_tpu.distributions import LOG_2PI
from cmcd_tpu.targets.base import Target

# numpy (not jnp) constants so importing this module never initializes the
# JAX backend (choosing the platform, GPU or CPU, must stay possible after
# import).
_R = onp.array(
    [10, 23, 23, 26, 17, 5, 53, 55, 32, 46, 10, 8, 10, 8, 23, 0, 3, 22, 15, 32, 3],
    onp.float32,
)
_N = onp.array(
    [39, 62, 81, 51, 39, 6, 74, 72, 51, 79, 13, 16, 30, 28, 45, 4, 12, 41, 30, 51, 7],
    onp.float32,
)
_X1 = onp.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], onp.float32)
_X2 = onp.array([0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1], onp.float32)

# Binomial coefficient constants (included by numpyro's BinomialLogits).
_LOG_BINOM = onp.asarray(
    gammaln(_N + 1) - gammaln(_R + 1) - gammaln(_N - _R + 1),
    onp.float32,
)

_GAMMA_ALPHA = 0.01
_GAMMA_RATE = 0.01
_GAMMA_LOG_NORM = _GAMMA_ALPHA * onp.log(_GAMMA_RATE) - gammaln(_GAMMA_ALPHA)


def make_seeds() -> Target:
    dim = 26  # 4 fixed effects + 21 random effects + tau

    def log_prob(z):
        """z: (N, 26) -> (N,). Layout [a_0, a_1, a_12, a_2, b(21), u_tau]."""
        a_0, a_1, a_12, a_2 = z[:, 0], z[:, 1], z[:, 2], z[:, 3]
        b = z[:, 4:25]  # (N, 21)
        u_tau = z[:, 25]
        tau = jnp.exp(u_tau)

        # Gamma(0.01, 0.01) prior on tau + log-Jacobian of exp.
        lp = (
            _GAMMA_LOG_NORM
            + (_GAMMA_ALPHA - 1.0) * u_tau
            - _GAMMA_RATE * tau
            + u_tau
        )
        # N(0, 10) priors on the fixed effects.
        for a in (a_0, a_1, a_12, a_2):
            lp += -0.5 * (a / 10.0) ** 2 - 0.5 * LOG_2PI - jnp.log(10.0)
        # b_j ~ N(0, tau^{-1/2}): scale^2 = 1/tau.
        lp += jnp.sum(
            -0.5 * b * b * tau[:, None] - 0.5 * LOG_2PI + 0.5 * u_tau[:, None],
            axis=-1,
        )
        # Binomial likelihood.
        logits = (
            a_0[:, None]
            + a_1[:, None] * _X1
            + a_2[:, None] * _X2
            + a_12[:, None] * _X1 * _X2
            + b
        )
        lp += jnp.sum(
            _LOG_BINOM + _R * logits - _N * jnp.logaddexp(0.0, logits), axis=-1
        )
        return lp

    return Target(name="seeds", dim=dim, log_prob=log_prob)
