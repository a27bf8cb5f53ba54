"""Integrator correctness tests.

Key invariants:
- For a normalized target, E[e^w] = Z = 1 for EVERY mode (the backward
  kernels are normalized densities, so w is a valid importance log-weight
  between two normalized path measures). With target == variational dist and
  small eps the weight variance is tiny, so logsumexp(w) - log N ~ 0 tightly.
- factor_sn = 0 at init makes every score-net-controlled mode coincide
  exactly with its uncontrolled counterpart (reference src/nn.py:63,70).
- Jensen: mean(-w) >= -ln Z = 0 for normalized targets.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as onp
import pytest
from jax.scipy.special import logsumexp

from cmcd_tpu import bounds
from cmcd_tpu.distributions import diag_gaussian_init
from cmcd_tpu.targets.base import Target


def std_normal_target(dim=2):
    def log_prob(z):
        return -0.5 * jnp.sum(z * z + jnp.log(2 * jnp.pi), axis=-1)

    return Target(name="stdnorm", dim=dim, log_prob=log_prob)


ALL_MODES = [
    "UHA",
    "MCD_ULA",
    "MCD_ULA_sn",
    "MCD_CAIS_sn",
    "MCD_CAIS_var_sn",
    "MCD_DNF",
    "MCD_U_a-lp",
    "MCD_U_a-lp-sna",
    "MCD_U_a-lp-sn",
    "MCD_U_e-lp",
    "MCD_U_e-lp-sna",
    "MCD_U_ea-lp-sn",
    "MCD_CAIS_UHA_sn",
]


def make_setup(mode, dim=2, nbridges=4, **kw):
    return bounds.CMCDSetup(mode=mode, dim=dim, nbridges=nbridges, emb_dim=8, **kw)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_lnz_unbiased_gaussian(mode):
    """ln Z estimate ~ 0 for a standard normal target with q = N(0, I)."""
    dim, n = 2, 4096
    target = std_normal_target(dim)
    setup = make_setup(mode, dim=dim)
    params, ctx = bounds.initialize(
        setup,
        target.log_prob,
        eps=0.01,
        eta=0.5,
        gamma=2.0,
        trainable=("eps", "vd", "eta", "gamma", "mgridref_y"),
    )
    neg_elbos, z = bounds.compute_elbos(
        params, jax.random.PRNGKey(0), n, ctx, setup
    )
    assert z.shape == (n, dim)
    assert bool(jnp.all(jnp.isfinite(neg_elbos)))
    ln_z = float(logsumexp(-neg_elbos) - jnp.log(n))
    assert abs(ln_z) < 0.05, f"{mode}: lnZ={ln_z}"
    # Jensen: mean negative elbo >= 0 up to MC noise.
    assert float(jnp.mean(neg_elbos)) > -0.05


@pytest.mark.parametrize(
    "controlled,uncontrolled",
    [("MCD_ULA_sn", "MCD_ULA"), ("MCD_CAIS_sn", "MCD_ULA"), ("MCD_CAIS_var_sn", "MCD_ULA")],
)
def test_zero_factor_sn_reduces_to_ula(controlled, uncontrolled):
    """At init (factor_sn = 0) the geffner net outputs exactly 0, so the
    controlled overdamped modes equal plain ULA step-for-step."""
    dim, n = 3, 64
    target = std_normal_target(dim)
    results = {}
    for mode in (controlled, uncontrolled):
        setup = make_setup(mode, dim=dim, nbridges=6)
        params, ctx = bounds.initialize(
            setup, target.log_prob, eps=0.05, trainable=("eps",)
        )
        neg_elbos, z = bounds.compute_elbos(
            params, jax.random.PRNGKey(7), n, ctx, setup
        )
        results[mode] = (onp.asarray(neg_elbos), onp.asarray(z))
    onp.testing.assert_allclose(
        results[controlled][0], results[uncontrolled][0], rtol=1e-5, atol=1e-5
    )
    onp.testing.assert_allclose(
        results[controlled][1], results[uncontrolled][1], rtol=1e-5, atol=1e-5
    )


def test_single_step_ula_weight_numpy_oracle():
    """One ULA bridge checked against a pure-numpy reimplementation."""
    dim, n = 2, 8
    target = std_normal_target(dim)
    setup = make_setup("MCD_ULA", dim=dim, nbridges=1)
    params, ctx = bounds.initialize(
        setup, target.log_prob, eps=0.1, trainable=("eps",)
    )
    key = jax.random.PRNGKey(3)
    neg_elbos, z_final = bounds.compute_elbos(params, key, n, ctx, setup)

    # Reproduce on the host. beta for nbridges=1: interp of target_x=[0.5].
    from cmcd_tpu.schedules import betas_from_grid
    from cmcd_tpu.distributions import diag_gaussian_sample

    p = {**params["train"], **params["notrain"]}
    betas = onp.asarray(betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"]))
    assert betas.shape == (1,)

    z_key, evolve_key = jax.random.split(key)
    z0 = onp.asarray(diag_gaussian_sample(z_key, p["vd"], n))
    eps = float(p["eps"])
    beta = betas[0]

    def logq(z):
        return -0.5 * (z**2 + onp.log(2 * onp.pi)).sum(-1)

    # grad U = -(beta * (-z) + (1-beta) * (-z)) = z for std normal everywhere
    fk_mean = z0 - eps * z0
    scale = onp.sqrt(2 * eps)
    step_key = jax.random.fold_in(evolve_key, 0)
    noise_key, _ = jax.random.split(step_key)
    noise = onp.asarray(jax.random.normal(noise_key, (n, dim)))
    z1 = fk_mean + scale * noise
    bk_mean = z1 - eps * z1

    def kernel_lp(x, mean):
        return (-0.5 * ((x - mean) / scale) ** 2 - 0.5 * onp.log(2 * onp.pi) - onp.log(scale)).sum(-1)

    w = -logq(z0) + kernel_lp(z0, bk_mean) - kernel_lp(z1, fk_mean) + logq(z1)
    onp.testing.assert_allclose(onp.asarray(z_final), z1, rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(onp.asarray(neg_elbos), -w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_gradients_finite(mode):
    """KL/VarGrad loss gradients exist and are finite for every mode."""
    dim, n = 2, 16
    target = std_normal_target(dim)
    setup = make_setup(mode, dim=dim, nbridges=3)
    params, ctx = bounds.initialize(
        setup,
        target.log_prob,
        eps=0.01,
        eta=0.5,
        gamma=2.0,
        trainable=bounds.default_trainable(mode),
    )
    loss_fn = bounds.loss_fn_for_mode(mode)

    def loss(train):
        return loss_fn({"train": train, "notrain": params["notrain"]},
                       jax.random.PRNGKey(1), n, ctx, setup)[0]

    grads = jax.grad(loss)(params["train"])
    flat, _ = jax.flatten_util.ravel_pytree(grads)
    assert bool(jnp.all(jnp.isfinite(flat))), f"{mode}: non-finite grads"


def test_cais_eps_schedules_run():
    dim, n = 2, 32
    target = std_normal_target(dim)
    for sched in ("linear", "cos_sq"):
        setup = make_setup("MCD_CAIS_sn", dim=dim, nbridges=4, eps_schedule=sched)
        params, ctx = bounds.initialize(setup, target.log_prob, eps=0.05)
        neg_elbos, _ = bounds.compute_elbos(params, jax.random.PRNGKey(0), n, ctx, setup)
        assert bool(jnp.all(jnp.isfinite(neg_elbos)))


def test_grad_clipping_paths_run():
    dim, n = 2, 32
    target = std_normal_target(dim)
    for mode in ("MCD_CAIS_sn", "MCD_CAIS_var_sn"):
        setup = make_setup(mode, dim=dim, nbridges=4, grad_clipping=True)
        params, ctx = bounds.initialize(setup, target.log_prob, eps=0.05)
        neg_elbos, _ = bounds.compute_elbos(params, jax.random.PRNGKey(0), n, ctx, setup)
        assert bool(jnp.all(jnp.isfinite(neg_elbos)))


def test_vargrad_stops_state_gradient():
    """VarGrad must not backprop through the trajectory: the vd gradient of
    the raw weights differs between CAIS and CAIS_var under the same draw."""
    dim, n = 2, 64
    target = std_normal_target(dim)

    grads = {}
    for mode in ("MCD_CAIS_sn", "MCD_CAIS_var_sn"):
        setup = make_setup(mode, dim=dim, nbridges=4)
        params, ctx = bounds.initialize(
            setup, target.log_prob, eps=0.05, trainable=("vd", "eps")
        )

        def mean_w(train):
            neg_elbos, _ = bounds.compute_elbos(
                {"train": train, "notrain": params["notrain"]},
                jax.random.PRNGKey(5), n, ctx, setup,
            )
            return jnp.mean(neg_elbos)

        grads[mode] = jax.grad(mean_w)(params["train"])["vd"]["mean"]

    assert not onp.allclose(
        onp.asarray(grads["MCD_CAIS_sn"]), onp.asarray(grads["MCD_CAIS_var_sn"])
    )


def test_uha_lfsteps_and_delta_h():
    dim, n = 2, 32
    target = std_normal_target(dim)
    setup = make_setup("UHA", dim=dim, nbridges=4, lfsteps=3)
    params, ctx = bounds.initialize(
        setup, target.log_prob, eps=0.05, eta=0.3, trainable=("eps", "eta", "md")
    )
    neg_elbos, z = bounds.compute_elbos(params, jax.random.PRNGKey(0), n, ctx, setup)
    assert bool(jnp.all(jnp.isfinite(neg_elbos)))
    assert z.shape == (n, dim)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_remat_steps_gradients_match(mode):
    """jax.checkpoint over bridge steps must not change KL gradients —
    only the backward-pass memory profile (SURVEY.md §7 hard part 3)."""
    import jax.flatten_util

    dim, n = 2, 32
    target = std_normal_target(dim)
    grads = {}
    for remat in (False, True):
        setup = bounds.CMCDSetup(
            mode=mode, dim=dim, nbridges=6, emb_dim=8, remat_steps=remat
        )
        params, ctx = bounds.initialize(
            setup, target.log_prob, eps=0.05, trainable=("eps", "vd")
        )

        def loss(train):
            return bounds.kl_bound(
                {"train": train, "notrain": params["notrain"]},
                jax.random.PRNGKey(3), n, ctx, setup,
            )[0]

        grads[remat] = jax.flatten_util.ravel_pytree(jax.grad(loss)(params["train"]))[0]
    onp.testing.assert_allclose(
        onp.asarray(grads[False]), onp.asarray(grads[True]), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("mode", ALL_MODES)
def test_injected_noise_reproduces_the_prng_stream(mode):
    """Each family's `noise` argument, filled with the normals its PRNG path
    draws (per-step fold_in keys; underdamped/UHA also the initial momentum
    at index nbridges), gives the same trajectory and log-weights."""
    from cmcd_tpu import integrators
    from cmcd_tpu.integrators import overdamped as od
    from cmcd_tpu.integrators import underdamped as ud
    from cmcd_tpu.integrators.base import step_keys
    from cmcd_tpu.integrators.uha import evolve_uha
    from cmcd_tpu.schedules import betas_from_grid

    dim, n, k = 2, 16, 4
    target = std_normal_target(dim)
    setup = make_setup(mode, dim=dim, nbridges=k)
    params, ctx = bounds.initialize(setup, target.log_prob, eps=0.05)
    p = bounds.merged_params(params)
    betas = betas_from_grid(p["mgridref_y"], p["gridref_x"], p["target_x"])
    key = jax.random.PRNGKey(4)
    z0 = jax.random.normal(jax.random.PRNGKey(5), (n, dim))
    steps = [jax.random.normal(step_keys(key, i)[0], (n, dim)) for i in range(k)]

    if mode in integrators._OVERDAMPED:
        spec = integrators._OVERDAMPED[mode]
        run = lambda noise: od.evolve_overdamped(key, z0, betas, p, ctx, spec, noise)
        noise = jnp.stack(steps)
    else:
        first = jax.random.normal(jax.random.fold_in(key, k), (n, dim))
        noise = jnp.stack([first] + steps)
        if mode == "UHA":
            run = lambda noise: evolve_uha(key, z0, betas, p, ctx, noise)
        else:
            spec = integrators._UNDERDAMPED[mode]
            run = lambda noise: ud.evolve_underdamped(key, z0, betas, p, ctx, spec, noise)
    z_a, w_a, _ = run(None)
    z_b, w_b, _ = run(noise)
    onp.testing.assert_allclose(onp.asarray(z_a), onp.asarray(z_b), rtol=1e-6, atol=1e-6)
    onp.testing.assert_allclose(onp.asarray(w_a), onp.asarray(w_b), rtol=1e-6, atol=1e-5)
