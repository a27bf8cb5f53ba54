"""Uncorrected Hamiltonian Annealing (UHA) integrator, batch-first.

Reference: src/ais_utils.py with the trainable momentum distribution of
src/momdist.py. Per bridge: partial momentum refresh
rho = eta * rho_prev + sqrt(1 - eta^2) * exp(md) * xi, an lfsteps-step
leapfrog under the annealed potential, and weight update
w += log N(rho_new; 0, e^md) - log N(rho; 0, e^md). A per-bridge
delta_H = (U + K)_init - (U + K)_final diagnostic is returned as aux
(src/ais_utils.py:38-55).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cmcd_tpu.distributions import momentum_log_prob
from cmcd_tpu.integrators.base import IntegratorContext, make_grad_u, step_keys


def evolve_uha(key, z, betas, params, ctx: IntegratorContext, noise=None):
    """Run nbridges UHA bridges. z: (N, dim). Returns (z, w_delta, delta_H).

    delta_H: (nbridges, N) per-bridge energy errors (diagnostic only).
    noise: optional (nbridges + 1, N, dim) normals — noise[0] the initial
    momentum base draw, noise[1:] the per-bridge refresh draws (for tests
    and for callers that draw the noise ahead of the loop).
    """
    n, dim = z.shape
    md = params["md"]  # momentum logscale, (dim,)
    grad_u = make_grad_u(ctx, params["vd"], None, None)

    def u_value(z, beta):
        from cmcd_tpu.distributions import diag_gaussian_log_prob

        return -(
            beta * ctx.target_log_prob(z)
            + (1.0 - beta) * diag_gaussian_log_prob(params["vd"], z)
        )

    inv_var = jnp.exp(-2.0 * md)

    def k_value(rho):
        return -momentum_log_prob(rho, md)

    def grad_k(rho):
        return rho * inv_var

    def leapfrog(z, rho, beta):
        u_init = u_value(z, beta)
        rho = rho - params["eps"] * grad_u(z, beta) / 2.0
        # Reference evaluates K at the post-half-kick rho (src/ais_utils.py:41)
        # and U at the pre-kick z — kept identical.
        k_init = k_value(rho)
        z = z + params["eps"] * grad_k(rho)

        def full_leap(carry, _):
            z, rho = carry
            rho = rho - params["eps"] * grad_u(z, beta)
            z = z + params["eps"] * grad_k(rho)
            return (z, rho), None

        if ctx.lfsteps > 1:
            (z, rho), _ = jax.lax.scan(
                full_leap, (z, rho), jnp.arange(ctx.lfsteps - 1)
            )

        u_final = u_value(z, beta)
        rho = rho - params["eps"] * grad_u(z, beta) / 2.0
        k_final = k_value(rho)
        delta_h = u_init + k_init - u_final - k_final
        return z, rho, delta_h

    def step(carry, i):
        z, rho_prev, w = carry
        beta = betas[i]
        if noise is None:
            noise_key, _ = step_keys(key, i)
            base = jax.random.normal(noise_key, rho_prev.shape)
        else:
            base = noise[i + 1]
        xi = jnp.exp(md) * base
        rho = params["eta"] * rho_prev + jnp.sqrt(1.0 - params["eta"] ** 2) * xi
        z_new, rho_new, delta_h = leapfrog(z, rho, beta)
        w = w + momentum_log_prob(rho_new, md) - momentum_log_prob(rho, md)
        return (z_new, rho_new, w), delta_h

    if noise is None:
        rho_key = jax.random.fold_in(key, ctx.nbridges)
        rho0 = jnp.exp(md) * jax.random.normal(rho_key, (n, dim))
    else:
        rho0 = jnp.exp(md) * noise[0]

    # w0 derived from z so it inherits device-varying axes under shard_map.
    w0 = 0.0 * z[:, 0]
    if ctx.remat_steps:
        step = jax.checkpoint(step)
    (z, _, w), delta_h = jax.lax.scan(
        step, (z, rho0, w0), jnp.arange(ctx.nbridges)
    )
    return z, w, delta_h
