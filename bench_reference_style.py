"""A faithful re-creation of the REFERENCE's execution structure for A/B
benchmarking (not used by the library). This mirrors how shreyaspadhy/CMCD
stages the computation — a per-chain scalar program vmapped over integer
seeds, with a split PRNG key carried through the scan
(src/mcdboundingmachine.py:193-203, src/mcd_cais_var.py:56-108) — written
from the spec, not copied.

bench.py measures this against the package's batch-first path on the same
card; the reported vs_baseline is batch-first / reference-style throughput.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def make_reference_style_vargrad(target_log_prob_single, dim, nbridges, apply_sn_single):
    """Returns loss(seeds, params) with the reference's structure.

    target_log_prob_single: (dim,) -> scalar
    apply_sn_single: (params_sn, (dim,), i) -> (dim,)
    """

    def log_q(vd, z):
        y = (z - vd["mean"]) * jnp.exp(-vd["logdiag"])
        return -0.5 * jnp.sum(y * y + jnp.log(2 * jnp.pi)) - jnp.sum(vd["logdiag"])

    def sample_kernel(rng_key, mean, scale):
        return mean + scale * jax.random.normal(rng_key, (mean.shape[0],))

    def log_prob_kernel(x, mean, scale):
        y = (x - mean) / scale
        return jnp.sum(-0.5 * (y * y + jnp.log(2 * jnp.pi)) - jnp.log(scale))

    def gradU(params, z, beta, clip=1e2):
        gp = jax.grad(lambda zz: log_q(params["vd"], zz))(z)
        gpc = jnp.clip(gp, -clip, clip)
        gu = jax.grad(target_log_prob_single)(z)
        guc = jnp.clip(gu, -clip, clip)
        return -1.0 * (beta * guc + (1.0 - beta) * gpc)

    def per_chain_elbo(seed, params, betas):
        rng_key_gen = jax.random.PRNGKey(seed)
        rng_key, rng_key_gen = jax.random.split(rng_key_gen)
        eps_z = jax.random.normal(rng_key, (dim,))
        z = params["vd"]["mean"] + jnp.exp(params["vd"]["logdiag"]) * eps_z
        w = -log_q(params["vd"], z)

        def evolve(aux, i):
            z, w, rng_key_gen = aux
            z = jax.lax.stop_gradient(z)
            beta = betas[i]
            eps = params["eps"]
            uf = gradU(params, z, beta)
            fk_mean = z - eps * uf - eps * apply_sn_single(params["sn"], z, i)
            scale = jnp.sqrt(2 * eps)
            rng_key, rng_key_gen = jax.random.split(rng_key_gen)
            z_new = sample_kernel(rng_key, fk_mean, scale)
            z_new = jax.lax.stop_gradient(z_new)
            ub = gradU(params, z_new, beta)
            bk_mean = z_new - eps * ub + eps * apply_sn_single(params["sn"], z_new, i + 1)
            fk_lp = log_prob_kernel(z_new, fk_mean, scale)
            bk_lp = log_prob_kernel(z, bk_mean, scale)
            w = w + bk_lp - fk_lp
            rng_key, rng_key_gen = jax.random.split(rng_key_gen)
            return (z_new, w, rng_key_gen), None

        rng_key, rng_key_gen = jax.random.split(rng_key_gen)
        (z, w_mom, _), _ = jax.lax.scan(
            evolve, (z, 0.0, rng_key_gen), jnp.arange(nbridges)
        )
        w = w + w_mom + target_log_prob_single(z)
        return -w, z

    def loss(seeds, params, betas):
        neg_elbos, z = jax.vmap(per_chain_elbo, in_axes=(0, None, None))(
            seeds, params, betas
        )
        return jnp.clip(jnp.var(neg_elbos, ddof=0), -1e7, 1e7), (neg_elbos, z)

    return loss
