"""Bounding machines: parameter initialization and the ELBO/VarGrad losses.

Reference: src/mcdboundingmachine.py and src/boundingmachine.py. Differences
by design (batch-first):
- Parameters live in a typed pytree {"train": {...}, "notrain": {...}}
  instead of one ravel_pytree flat vector; the frozen subtree gets
  stop_gradient at loss time exactly like the reference
  (src/mcdboundingmachine.py:141-143).
- The ELBO is computed for the whole chain batch at once (z: (N, dim))
  instead of vmapping a per-chain scalar program
  (src/mcdboundingmachine.py:193-203).
- Randomness: one PRNG key per loss call, folded per chain-batch draw and
  per bridge step, instead of per-chain integer seeds re-keyed inside vmap
  (src/mcdboundingmachine.py:151). Parity with the reference PRNG stream is
  statistical, not bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from cmcd_tpu import integrators
from cmcd_tpu.distributions import (
    diag_gaussian_init,
    diag_gaussian_log_prob,
    diag_gaussian_sample,
    momentum_init,
)
from cmcd_tpu.integrators.base import IntegratorContext
from cmcd_tpu.networks import build_score_network
from cmcd_tpu.schedules import betas_from_grid, make_beta_grid_params


# Modes whose reference implementation threads the eps schedule through
# (src/mcd_cais.py:34-44, src/mcd_cais_var.py); MCD_CAIS_UHA_sn hardcodes a
# cosine schedule in its spec instead (src/mcd_under_lp_a_cais.py:48). All
# other modes ignore --config.eps_schedule, exactly as the reference
# dispatcher does (src/mcd_utils.py passes no schedule to
# evolve_overdamped_orig / the underdamped lp evolvers).
_EPS_SCHEDULE_MODES = ("MCD_CAIS_sn", "MCD_CAIS_var_sn")


@dataclasses.dataclass(frozen=True)
class CMCDSetup:
    """Static (hashable) configuration of a bound. Safe as a jit static arg."""

    mode: str
    dim: int
    nbridges: int
    eps_schedule: str = ""
    grad_clipping: bool = False
    lfsteps: int = 1
    emb_dim: int = 20
    nlayers: int = 2
    nn_arch: str = "geffner"
    fully_connected_units: tuple = (64, 64)
    # Per-step rematerialization for KL/BPTT training at large nbridges.
    remat_steps: bool = False

    def __post_init__(self):
        if self.eps_schedule and self.mode not in _EPS_SCHEDULE_MODES:
            object.__setattr__(self, "eps_schedule", "")

    def context(self, target_log_prob: Callable, apply_sn=None, apply_sn2=None):
        return IntegratorContext(
            target_log_prob=target_log_prob,
            nbridges=self.nbridges,
            dim=self.dim,
            apply_sn=apply_sn,
            apply_sn2=apply_sn2,
            eps_schedule=self.eps_schedule,
            grad_clipping=self.grad_clipping,
            lfsteps=self.lfsteps,
            remat_steps=self.remat_steps,
        )


def default_trainable(mode: str, train_eps=True, train_vi=True, train_betas=True):
    """Trainable-set logic of src/main.py:115-145 (with the UHA string bug
    fixed: the reference sets trainable='eta' as a str, crashing when any
    train_* flag is on; here UHA gets a proper tuple)."""
    trainable = ("eta",) if mode == "UHA" else ("eta", "gamma")
    if train_eps:
        trainable = trainable + ("eps",)
    if train_vi:
        trainable = trainable + ("vd",)
    if train_betas:
        trainable = trainable + ("mgridref_y",)
    return trainable


def initialize(
    setup: CMCDSetup,
    target_log_prob: Callable,
    vdparams=None,
    eps: float = 0.01,
    gamma: float = 10.0,
    eta: float = 0.5,
    ngridb: int = 32,
    mgridref_y=None,
    trainable=("eps",),
    init_sigma: float = 1.0,
    mdparams=None,
    seed: int = 1,
):
    """Build the parameter pytree and the evolve context.

    Returns (params, ctx) where params = {"train": {...}, "notrain": {...}}.
    Mirrors src/mcdboundingmachine.py:11-123 and src/boundingmachine.py:9-70.
    """
    train: dict[str, Any] = {}
    notrain: dict[str, Any] = {}

    def place(name, value):
        (train if name in trainable else notrain)[name] = value

    place("vd", vdparams if vdparams is not None else diag_gaussian_init(setup.dim, init_sigma))
    place("eps", jnp.asarray(eps, jnp.float32))
    place("gamma", jnp.asarray(gamma, jnp.float32))
    place("eta", jnp.asarray(eta, jnp.float32))

    apply_sn = apply_sn2 = None
    if integrators.mode_uses_score_network(setup.mode):
        rho_dim = integrators.mode_sn_rho_dim(setup.mode, setup.dim)
        init_sn, apply_sn = build_score_network(
            setup.dim,
            setup.emb_dim,
            setup.nbridges,
            rho_dim=rho_dim,
            nlayers=setup.nlayers,
            arch=setup.nn_arch,
            fully_connected_units=list(setup.fully_connected_units),
            target_log_prob=target_log_prob,
        )
        train["sn"] = init_sn(jax.random.PRNGKey(seed))
        if setup.mode == "MCD_DNF":
            # Second backward network — uninitialized (broken) in the
            # reference (src/vi_dnf.py:57); working here.
            init_sn2, apply_sn2 = build_score_network(
                setup.dim,
                setup.emb_dim,
                setup.nbridges,
                rho_dim=0,
                nlayers=setup.nlayers,
                arch=setup.nn_arch,
                fully_connected_units=list(setup.fully_connected_units),
                target_log_prob=target_log_prob,
            )
            train["sn2"] = init_sn2(jax.random.PRNGKey(seed + 1))

    if setup.mode == "UHA":
        place("md", mdparams if mdparams is not None else momentum_init(setup.dim))

    mg, gridref_x, target_x = make_beta_grid_params(setup.nbridges, ngridb, mgridref_y)
    place("mgridref_y", mg)
    notrain["gridref_x"] = gridref_x
    notrain["target_x"] = target_x

    params = {"train": train, "notrain": notrain}
    ctx = setup.context(target_log_prob, apply_sn, apply_sn2)
    return params, ctx


def merged_params(params):
    """train + stop_gradient(notrain), one flat dict (reference :141-143)."""
    notrain = jax.lax.stop_gradient(params["notrain"])
    return {**params["train"], **notrain}


def compute_elbos(params, key, n_chains: int, ctx: IntegratorContext, setup: CMCDSetup):
    """Per-chain negative ELBOs and final states.

    Returns (neg_elbos (N,), z (N, dim)). neg_elbo = -w where
    w = -log q(z_1) + sum_k [log B_k - log F_k] + log pi(z_K)
    (src/mcdboundingmachine.py:126-179).
    """
    p = merged_params(params)
    z_key, evolve_key = jax.random.split(key)

    z = diag_gaussian_sample(z_key, p["vd"], n_chains)
    w = -diag_gaussian_log_prob(p["vd"], z)

    if setup.nbridges >= 1:
        betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
        z, w_delta, _ = integrators.evolve(evolve_key, z, betas, p, ctx, setup.mode)
        w = w + w_delta

    w = w + ctx.target_log_prob(z)
    return -w, z


def kl_bound(params, key, n_chains: int, ctx, setup):
    """Mean negative ELBO (the KL training loss, reference :183-205)."""
    neg_elbos, z = compute_elbos(params, key, n_chains, ctx, setup)
    return jnp.mean(neg_elbos), (neg_elbos, z)


def var_bound(params, key, n_chains: int, ctx, setup):
    """VarGrad loss: clipped batch variance of the negative ELBOs
    (reference :208-231). Gradient flow through the state is already cut by
    the integrator's stop_gradients for MCD_CAIS_var_sn."""
    neg_elbos, z = compute_elbos(params, key, n_chains, ctx, setup)
    return jnp.clip(jnp.var(neg_elbos, ddof=0), -1e7, 1e7), (neg_elbos, z)


def loss_fn_for_mode(mode: str):
    return var_bound if "var" in mode else kl_bound
