"""Underdamped (leapfrog) annealed-SDE integrators, batch-first.

One parameterized stepper covering the reference modes:
- MCD_U_a-lp / -sna / -sn  (src/mcd_under_lp_a.py): OU ("approximate")
  momentum refresh rho' ~ N(rho (1 - gamma eps), 2 gamma eps I)
- MCD_U_e-lp / -sna        (src/mcd_under_lp_e.py): exact refresh
  rho' ~ N(eta rho, (1 - eta^2) I)
- MCD_U_ea-lp-sn           (src/mcd_under_lp_ea.py): exact forward with
  eta = exp(-gamma eps), approximate backward (asymmetric kernel scales)
- MCD_CAIS_UHA_sn          (src/mcd_under_lp_a_cais.py): score net in both
  momentum kernels on concat[z, rho], hardcoded cosine eps schedule,
  clipped target grad

All share: one leapfrog step per bridge, endpoint momentum corrections
w -= log N(rho_0; 0, I) at the start and w += log N(rho_K; 0, I) at the end
(src/mcd_under_lp_a.py:71,85).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cmcd_tpu.distributions import kernel_log_prob, std_normal_log_prob
from cmcd_tpu.integrators.base import IntegratorContext, make_grad_u, step_keys
from cmcd_tpu.schedules import eps_cosine_sq


@dataclasses.dataclass(frozen=True)
class UnderdampedSpec:
    refresh: str = "approx"   # "approx" | "exact" | "exact_fwd"
    bwd_sn: str = "none"      # "none" | "state" (z only) | "full" ([z, rho'])
    fwd_sn: bool = False      # CAIS: score net in the forward refresh too
    cais: bool = False        # CAIS: cosine eps schedule + clipped target grad


U_A_LP = UnderdampedSpec(refresh="approx", bwd_sn="none")
U_A_LP_SNA = UnderdampedSpec(refresh="approx", bwd_sn="state")
U_A_LP_SN = UnderdampedSpec(refresh="approx", bwd_sn="full")
U_E_LP = UnderdampedSpec(refresh="exact", bwd_sn="none")
U_E_LP_SNA = UnderdampedSpec(refresh="exact", bwd_sn="state")
U_EA_LP_SN = UnderdampedSpec(refresh="exact_fwd", bwd_sn="full")
CAIS_UHA = UnderdampedSpec(refresh="approx", bwd_sn="full", fwd_sn=True, cais=True)


def evolve_underdamped(
    key, z, betas, params, ctx: IntegratorContext, spec: UnderdampedSpec, noise=None
):
    """Run nbridges underdamped leapfrog steps. z: (N, dim).

    Returns (z, w_delta, aux). The initial momentum draw and endpoint
    corrections are included in w_delta.

    noise: optional (nbridges + 1, N, dim) normals — noise[0] replaces the
    initial momentum draw, noise[1:] the per-step refresh draws (for tests
    and for callers that draw the noise ahead of the loop).
    """
    n, dim = z.shape
    apply_sn = ctx.apply_sn

    if spec.cais:
        # Reference hardcodes stable=True with target clip 1e2, vd unclipped
        # (src/mcd_under_lp_a_cais.py:23-29,41).
        grad_u = make_grad_u(ctx, params["vd"], 1e2, None)
    else:
        grad_u = make_grad_u(ctx, params["vd"], None, None)

    def step(carry, i):
        z, rho, w = carry
        beta = betas[i]

        if spec.cais:
            eps = eps_cosine_sq(params["eps"], i, ctx.nbridges)
        else:
            eps = params["eps"]

        # --- Forward momentum refresh ---------------------------------
        if spec.refresh == "approx":
            eta_aux = params["gamma"] * eps
            fk_mean = rho * (1.0 - eta_aux)
            fwd_scale = jnp.sqrt(2.0 * eta_aux)
            bwd_scale = fwd_scale
        elif spec.refresh == "exact":
            eta = params["eta"]
            fk_mean = eta * rho
            fwd_scale = jnp.sqrt(1.0 - eta**2)
            bwd_scale = fwd_scale
        elif spec.refresh == "exact_fwd":
            # Exact forward, approximate backward: the two kernels use
            # different scales (src/mcd_under_lp_ea.py:28-33,60-61).
            eta_aux = params["gamma"] * params["eps"]
            eta = jnp.exp(-eta_aux)
            fk_mean = eta * rho
            fwd_scale = jnp.sqrt(1.0 - eta**2)
            bwd_scale = jnp.sqrt(2.0 * eta_aux)
        else:
            raise ValueError(spec.refresh)

        if spec.fwd_sn:
            sn_in = jnp.concatenate([z, rho], axis=-1)
            fk_mean = fk_mean - 2.0 * eta_aux * apply_sn(params["sn"], sn_in, i)

        if noise is None:
            noise_key, _ = step_keys(key, i)
            xi = jax.random.normal(noise_key, rho.shape)
        else:
            xi = noise[i + 1]
        rho_prime = fk_mean + fwd_scale * xi

        # --- One leapfrog step -----------------------------------------
        rho_pp = rho_prime - eps * grad_u(z, beta) / 2.0
        z_new = z + eps * rho_pp
        rho_new = rho_pp - eps * grad_u(z_new, beta) / 2.0

        # --- Backward momentum kernel mean -----------------------------
        if spec.refresh == "exact":
            bk_mean = params["eta"] * rho_prime
            if spec.bwd_sn == "state":
                bk_mean = bk_mean + 2.0 * apply_sn(params["sn"], z, i) * (
                    1.0 - params["eta"]
                )
            elif spec.bwd_sn == "full":
                sn_in = jnp.concatenate([z, rho_prime], axis=-1)
                bk_mean = bk_mean + 2.0 * apply_sn(params["sn"], sn_in, i) * (
                    1.0 - params["eta"]
                )
        else:
            bk_mean = rho_prime * (1.0 - eta_aux)
            if spec.bwd_sn == "state":
                bk_mean = bk_mean + 2.0 * eta_aux * apply_sn(params["sn"], z, i)
            elif spec.bwd_sn == "full":
                sn_in = jnp.concatenate([z, rho_prime], axis=-1)
                bk_mean = bk_mean + 2.0 * eta_aux * apply_sn(params["sn"], sn_in, i)

        fk_log_prob = kernel_log_prob(rho_prime, fk_mean, fwd_scale)
        bk_log_prob = kernel_log_prob(rho, bk_mean, bwd_scale)
        w = w + bk_log_prob - fk_log_prob
        return (z_new, rho_new, w), None

    # Initial momentum ~ N(0, I); endpoint corrections
    # (src/mcd_under_lp_a.py:65-71,82-85).
    # Step keys fold in 0..nbridges-1; index nbridges is free for this draw.
    if noise is None:
        rho_key = jax.random.fold_in(key, ctx.nbridges)
        rho = jax.random.normal(rho_key, (n, dim))
    else:
        rho = noise[0]
    w0 = -std_normal_log_prob(rho)

    if ctx.remat_steps:
        step = jax.checkpoint(step)
    (z, rho, w), _ = jax.lax.scan(step, (z, rho, w0), jnp.arange(ctx.nbridges))
    w = w + std_normal_log_prob(rho)
    return z, w, None
