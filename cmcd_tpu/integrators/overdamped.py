"""Overdamped (Langevin) annealed-SDE integrators, batch-first.

One parameterized stepper covering the reference modes:
- MCD_ULA          (src/mcd_over_orig.py, use_sn=False)
- MCD_ULA_sn       (src/mcd_over_orig.py, use_sn=True; backward net at step i)
- MCD_CAIS_sn      (src/mcd_cais.py; forward net at i, backward net at i+1)
- MCD_CAIS_var_sn  (src/mcd_cais_var.py; + stop_gradient on the state)
- MCD_DNF          (src/vi_dnf.py; zero annealed drift, two nets — the
                    reference ships this broken with sn_2 uninitialized; here
                    it works)

Forward kernel:  z' ~ N(z - eps * gradU(z, b) [- eps * sn(z, i)], 2 eps I)
Backward kernel: log N(z; z' - eps * gradU(z', b) [+ eps * sn(z', i+off)], 2 eps I)
Weight update:   w += log B - log F   (src/mcd_cais.py:82-86)

The reference's backward-net index i+1 relies on silent XLA gather clamping
at the last bridge (src/mcd_cais.py:78 with src/nn.py:68); the clamp is
explicit in the network apply here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from cmcd_tpu.distributions import kernel_log_prob
from cmcd_tpu.integrators.base import IntegratorContext, make_grad_u, step_keys
from cmcd_tpu.schedules import eps_at_step


@dataclasses.dataclass(frozen=True)
class OverdampedSpec:
    fwd_sn: bool = False          # score net in the forward drift (CAIS)
    bwd_sn: bool = False          # score net in the backward mean
    bwd_sn_offset: int = 0        # 0 for ULA_sn, 1 for CAIS
    stop_grad_state: bool = False  # VarGrad: cut BPTT through the state
    clip_target: Optional[float] = None  # grad clip when ctx.grad_clipping
    clip_vd: Optional[float] = None
    zero_drift: bool = False      # DNF: annealed drift removed entirely
    use_sn2_bwd: bool = False     # DNF: backward uses the second net


ULA = OverdampedSpec()
ULA_SN = OverdampedSpec(bwd_sn=True, bwd_sn_offset=0)
CAIS = OverdampedSpec(
    fwd_sn=True, bwd_sn=True, bwd_sn_offset=1, clip_target=1e3, clip_vd=None
)
CAIS_VAR = OverdampedSpec(
    fwd_sn=True,
    bwd_sn=True,
    bwd_sn_offset=1,
    stop_grad_state=True,
    clip_target=1e2,
    clip_vd=1e2,
)
DNF = OverdampedSpec(
    fwd_sn=True, bwd_sn=True, bwd_sn_offset=1, zero_drift=True, use_sn2_bwd=True
)


def evolve_overdamped(
    key, z, betas, params, ctx: IntegratorContext, spec: OverdampedSpec, noise=None
):
    """Run nbridges overdamped steps. z: (N, dim). Returns (z, w_delta, aux).

    eps scheduling and grad clipping follow the reference switches: the
    schedule applies to CAIS modes via ctx.eps_schedule
    (src/mcd_cais.py:54-59); clipping only when ctx.grad_clipping
    (src/mcd_cais.py:52).

    noise: optional (nbridges, N, dim) pre-drawn standard normals replacing
    the per-step PRNG draws (for tests and for callers that draw the noise
    ahead of the loop).
    """
    n = z.shape[0]

    if spec.zero_drift:
        grad_u = lambda zz, bb: jnp.zeros_like(zz)
    elif ctx.grad_clipping:
        grad_u = make_grad_u(ctx, params["vd"], spec.clip_target, spec.clip_vd)
    else:
        grad_u = make_grad_u(ctx, params["vd"], None, None)

    apply_sn = ctx.apply_sn
    apply_sn_bwd = ctx.apply_sn2 if spec.use_sn2_bwd else ctx.apply_sn

    def step(carry, i):
        z, w = carry
        if spec.stop_grad_state:
            z = jax.lax.stop_gradient(z)
        beta = betas[i]
        eps = eps_at_step(params["eps"], i, ctx.nbridges, ctx.eps_schedule)
        scale = jnp.sqrt(2.0 * eps)

        fk_mean = z - eps * grad_u(z, beta)
        if spec.fwd_sn:
            fk_mean = fk_mean - eps * apply_sn(params["sn"], z, i)

        if noise is None:
            noise_key, _ = step_keys(key, i)
            xi = jax.random.normal(noise_key, z.shape)
        else:
            xi = noise[i]
        z_new = fk_mean + scale * xi
        if spec.stop_grad_state:
            z_new = jax.lax.stop_gradient(z_new)

        bk_mean = z_new - eps * grad_u(z_new, beta)
        if spec.bwd_sn:
            bk_mean = bk_mean + eps * apply_sn_bwd(
                params["sn2"] if spec.use_sn2_bwd else params["sn"],
                z_new,
                i + spec.bwd_sn_offset,
            )

        fk_log_prob = kernel_log_prob(z_new, fk_mean, scale)
        bk_log_prob = kernel_log_prob(z, bk_mean, scale)
        w = w + bk_log_prob - fk_log_prob
        return (z_new, w), None

    # Derive w0 from z (not a fresh constant) so it inherits z's device-varying
    # axes under shard_map.
    w0 = 0.0 * z[:, 0]
    if ctx.remat_steps:
        step = jax.checkpoint(step)
    (z, w), _ = jax.lax.scan(step, (z, w0), jnp.arange(ctx.nbridges))
    return z, w, None
