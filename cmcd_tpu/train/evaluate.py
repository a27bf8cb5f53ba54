"""Evaluation protocol: final ELBO and ln Z over independent seed groups.

Reference: src/opt.py:167-197 + src/utils.py:219-248. The reference loops 30
seed groups in Python and syncs every chain loss to host one .item() at a
time (a 15,000-way serial device->host sync, src/opt.py:193); here the whole
(n_seeds, n_samples) ELBO matrix is produced by a vmapped jitted call and the
ln Z aggregation runs on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from cmcd_tpu import bounds


def evaluate(
    params,
    ctx,
    setup: bounds.CMCDSetup,
    *,
    key,
    n_samples: int = 500,
    n_input_dist_seeds: int = 30,
    elbo_fn=None,
):
    """Returns a dict with final_elbo / final_ln_Z (+stds), the full
    (n_seeds, n_samples) negative-ELBO matrix, and final samples.

    ELBO_s = mean_i(-L_si); ln Z_s = logsumexp_i(-L_si) - log n_samples;
    reported values are means over s with stds (src/utils.py:219-248).

    elbo_fn: optional (params, key, n) -> (neg_elbos, z) override — e.g. the
    sharded one (parallel.sharded_compute_elbos).
    """
    keys = jax.random.split(key, n_input_dist_seeds)

    if elbo_fn is None:
        def elbo_fn(p, k, n):
            return bounds.compute_elbos(p, k, n, ctx, setup)

    @jax.jit
    def one_group(k):
        return elbo_fn(params, k, n_samples)

    neg_elbos, zs = jax.lax.map(one_group, keys)  # (S, n), (S, n, dim)

    elbos = -jnp.mean(neg_elbos, axis=1)
    ln_zs = logsumexp(-neg_elbos, axis=1) - jnp.log(n_samples)
    # Host copies: the matrix/samples feed host-side reporting (W2, plots),
    # and a sharded zs (multi-device elbo_fn) cannot be reshaped on device.
    zs = jax.device_get(zs)
    return {
        "final_elbo": float(jnp.mean(elbos)),
        "final_elbo_std": float(jnp.std(elbos)),
        "final_ln_Z": float(jnp.mean(ln_zs)),
        "final_ln_Z_std": float(jnp.std(ln_zs)),
        "neg_elbos": jax.device_get(neg_elbos),
        "samples": zs.reshape(-1, zs.shape[-1]),
    }
