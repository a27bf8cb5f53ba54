"""Bayesian logistic regression targets (log_sonar, log_ionosphere, ...).

Reference: src/models/logistic_regression.py + src/models/data_utils.py via
numpyro's potential_fn (src/model_handler.py:67-86). The model is
  w ~ N(0, I_dim);  y_i ~ Bernoulli(logits = x_i . w)
over standardized, bias-padded features. All parameters are unconstrained,
so the numpyro potential is just -(log prior + log likelihood); implemented
directly, batched. Datasets are shipped as .npz conversions of the
reference's pickles (same arrays bit-for-bit).
"""

from __future__ import annotations

import os

import numpy as onp
import jax
import jax.numpy as jnp

from cmcd_tpu.distributions import LOG_2PI
from cmcd_tpu.targets.base import Target

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

# w @ x.T runs at full float32 precision. At a GPU's default (TF32 inputs)
# the log-density of 128 points from N(0, I) is up to 2.0e-4 (sonar) and
# 3.5e-4 (ionosphere) off in relative terms (chip_smoke.py phase 5d, NVIDIA
# H100 80GB HBM3 at 400 W), past the 1e-4 the targets are held to.
_PRECISION = jax.lax.Precision.HIGHEST


def _standardize_and_pad(x):
    """Z-score features then prepend a constant-1 bias column
    (reference src/models/data_utils.py:6-21)."""
    mean = onp.mean(x, axis=0)
    std = onp.std(x, axis=0)
    std[std == 0] = 1.0
    x = (x - mean) / std
    return onp.hstack([onp.ones((x.shape[0], 1)), x])


def load_logreg_data(dset: str):
    data = onp.load(os.path.join(_DATA_DIR, f"{dset}.npz"))
    x, y = data["X"], data["Y"]
    y = (y + 1) // 2  # {-1, 1} -> {0, 1} (reference logistic_regression.py:10-28)
    x = _standardize_and_pad(x)
    return jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)


def make_logreg(dset: str = "sonar") -> Target:
    x, y = load_logreg_data(dset)
    dim = x.shape[1]

    def log_prob(w):
        """w: (N, dim) -> (N,)."""
        log_prior = -0.5 * jnp.sum(w * w + LOG_2PI, axis=-1)
        logits = jnp.matmul(w, x.T, precision=_PRECISION)  # (N, n_data)
        # Bernoulli-logits log pmf: y * l - softplus(l)
        log_lik = jnp.sum(y * logits - jnp.logaddexp(0.0, logits), axis=-1)
        return log_prior + log_lik

    return Target(name=f"log_{dset}", dim=dim, log_prob=log_prob, params={"dset": dset})
