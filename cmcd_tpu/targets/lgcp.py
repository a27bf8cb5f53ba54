"""Log-Gaussian Cox process on the Finnish pines data (1600-dim).

Reference: src/model_handler.py:287-409 + src/cp_utils.py (itself derived
from annealed_flow_transport's cp_utils). Same discretization (40x40 grid),
kernel (sigma^2 = 1.91, length scale 1/33), and Poisson likelihood.

Design changes (identical math):
- The Gram matrix is built with one vectorized pairwise-distance broadcast
  instead of a vmap-of-vmap of a scalar kernel (src/cp_utils.py:53-55).
- The unwhitened prior quadratic form uses a precomputed L^{-1} dense
  matmul instead of a per-evaluation triangular solve
  (src/cp_utils.py:132-155) — a triangular solve is sequential along the
  1600 rows and appears inside every SDE step via grad(U), where a (N, 1600)
  x (1600, 1600) product is one library matmul.
- log_prob is natively batched: (N, 1600) -> (N,).
"""

from __future__ import annotations

import os

import numpy as onp
import jax
import jax.numpy as jnp

from cmcd_tpu.targets.base import Target

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

# The two 1600 x 1600 products run at full float32 precision. At a GPU's
# default (TF32 inputs) their 1600-term sums put the unwhitened log-density
# 1.9e-4 off in relative terms on 128 points from the chains' initial
# distribution (chip_smoke.py phase 5c, NVIDIA H100 80GB HBM3 at 400 W),
# past the 1e-4 this target is held to.
_PRECISION = jax.lax.Precision.HIGHEST


def get_bin_counts(points: onp.ndarray, num_bins_per_dim: int) -> onp.ndarray:
    """Count points per grid cell; exact edge rule of src/cp_utils.py:16-42
    (points on the upper edge fall into the last bin)."""
    scaled = points * num_bins_per_dim
    idx = onp.floor(scaled).astype(int)
    idx = onp.minimum(idx, num_bins_per_dim - 1)
    counts = onp.zeros((num_bins_per_dim, num_bins_per_dim))
    for row, col in idx:
        counts[row, col] += 1
    return counts


def get_bin_vals(num_bins: int) -> onp.ndarray:
    """Grid coordinates in row-major (i, j) order (src/cp_utils.py:45-50)."""
    ii, jj = onp.meshgrid(onp.arange(num_bins), onp.arange(num_bins), indexing="ij")
    return onp.stack([ii.ravel(), jj.ravel()], axis=-1).astype(onp.float64)


def gram_matrix(bin_vals, signal_variance, num_grid_per_dim, raw_length_scale):
    """K(m, n) = sv * exp(-|m - n| / (M * ell)) — one broadcasted computation
    (src/cp_utils.py:58-84 computed it pointwise under vmap^2)."""
    diff = bin_vals[:, None, :] - bin_vals[None, :, :]
    dist = onp.sqrt(onp.sum(diff * diff, axis=-1))
    return signal_variance * onp.exp(-dist / (num_grid_per_dim * raw_length_scale))


def poisson_process_log_likelihood(latents, bin_area, flat_bin_counts):
    """Batched: latents (N, D) -> (N,) (src/cp_utils.py:87-104)."""
    return jnp.sum(
        latents * flat_bin_counts - bin_area * jnp.exp(latents), axis=-1
    )


def make_lgcp(use_whitened: bool = False, file_path: str | None = None, num_dim: int = 1600) -> Target:
    num_grid_per_dim = int(onp.sqrt(num_dim))
    if num_grid_per_dim * num_grid_per_dim != num_dim:
        raise ValueError("num_dim must be a square number for LGCP")
    if file_path is None:
        file_path = os.path.join(_DATA_DIR, "pines.csv")

    pines = onp.genfromtxt(file_path, delimiter=",")
    flat_bin_counts = jnp.asarray(
        get_bin_counts(pines, num_grid_per_dim).reshape(num_dim), jnp.float32
    )

    poisson_a = 1.0 / num_dim
    signal_variance = 1.91
    beta = 1.0 / 33

    bin_vals = get_bin_vals(num_grid_per_dim)
    gram = gram_matrix(bin_vals, signal_variance, num_grid_per_dim, beta)
    cholesky_gram = onp.linalg.cholesky(gram)
    # L^{-1} once on host (float64): the prior quadratic form becomes
    # ||L^{-1}(z - mu)||^2 — one dense matmul and numerically better
    # than a Sigma^{-1} quadratic form (squaring happens after the matmul).
    chol_inv = onp.linalg.inv(cholesky_gram)

    half_log_det = onp.sum(onp.log(onp.abs(onp.diag(cholesky_gram))))
    white_log_normalizer = -0.5 * num_dim * onp.log(2.0 * onp.pi)
    unwhite_log_normalizer = white_log_normalizer - half_log_det
    mu_zero = onp.log(126.0) - 0.5 * signal_variance

    chol = jnp.asarray(cholesky_gram, jnp.float32)
    chol_inv = jnp.asarray(chol_inv, jnp.float32)

    def whitened_log_prob(white):
        """white: (N, D) -> (N,) (src/model_handler.py:375-384)."""
        prior = white_log_normalizer - 0.5 * jnp.sum(white * white, axis=-1)
        latents = jnp.matmul(white, chol.T, precision=_PRECISION) + mu_zero
        return prior + poisson_process_log_likelihood(
            latents, poisson_a, flat_bin_counts
        )

    def unwhitened_log_prob(latents):
        """latents: (N, D) -> (N,) (src/model_handler.py:386-396)."""
        white = jnp.matmul(latents - mu_zero, chol_inv.T, precision=_PRECISION)
        prior = unwhite_log_normalizer - 0.5 * jnp.sum(white * white, axis=-1)
        return prior + poisson_process_log_likelihood(
            latents, poisson_a, flat_bin_counts
        )

    log_prob = whitened_log_prob if use_whitened else unwhitened_log_prob
    default_path = os.path.join(_DATA_DIR, "pines.csv")
    return Target(
        name="lgcp",
        dim=num_dim,
        log_prob=log_prob,
        params={
            "use_whitened": use_whitened,
            "num_dim": num_dim,
            "default_data": os.path.abspath(file_path) == os.path.abspath(default_path),
        },
    )
