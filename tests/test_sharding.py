"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as onp
import pytest

from cmcd_tpu import bounds
from cmcd_tpu import parallel
from cmcd_tpu.integrators import ALL_MODES
from cmcd_tpu.targets.base import Target


def std_normal_target(dim=2):
    def log_prob(z):
        return -0.5 * jnp.sum(z * z + jnp.log(2 * jnp.pi), axis=-1)

    return Target(name="stdnorm", dim=dim, log_prob=log_prob)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest should provide 8 virtual devices"
    return parallel.make_chain_mesh(8)


def test_sharded_elbos_shapes_and_finite(mesh):
    target = std_normal_target(2)
    setup = bounds.CMCDSetup(mode="MCD_CAIS_sn", dim=2, nbridges=4, emb_dim=8)
    params, ctx = bounds.initialize(setup, target.log_prob, eps=0.01)

    neg_elbos, z = jax.jit(
        lambda p, k: parallel.sharded_compute_elbos(p, k, 256, ctx, setup, mesh)
    )(params, jax.random.PRNGKey(0))
    assert neg_elbos.shape == (256,)
    assert z.shape == (256, 2)
    assert bool(jnp.all(jnp.isfinite(neg_elbos)))
    # Output really is sharded over the chain axis.
    assert len(neg_elbos.sharding.device_set) == 8


def test_sharded_lnz_matches_tolerance(mesh):
    target = std_normal_target(2)
    setup = bounds.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=4)
    params, ctx = bounds.initialize(setup, target.log_prob, eps=0.01)
    neg_elbos, _ = parallel.sharded_compute_elbos(
        params, jax.random.PRNGKey(1), 4096, ctx, setup, mesh
    )
    ln_z = float(jax.jit(parallel.sharded_ln_z)(neg_elbos))
    assert abs(ln_z) < 0.05


@pytest.mark.parametrize("mode", ALL_MODES)
def test_sharded_loss_gradients_match_single_device_statistics(mode):
    """The chain-sharded train loss on 4 devices equals the same 4 chain
    shards (same fold_in(key, shard) streams) computed one after another on
    one device (the CPU twin of chip_smoke.py phase 6). Both run in float64:
    the two programs fuse and sum in different orders, which in float32
    moves a cancelling sum (UHA's log-weights at target == q) by ~1e-6; in
    float64 every difference left is below 1e-12."""
    target = std_normal_target(2)
    setup = bounds.CMCDSetup(mode=mode, dim=2, nbridges=4, emb_dim=8)
    trainable = bounds.default_trainable(mode)
    params, ctx = bounds.initialize(
        setup, target.log_prob, eps=0.05, trainable=trainable
    )
    mesh4 = parallel.make_chain_mesh(4)
    key = jax.random.PRNGKey(5)

    def value_and_grad(loss_fn, train):
        def loss(tr):
            return loss_fn(
                {"train": tr, "notrain": params["notrain"]}, key, 64, ctx, setup
            )

        (l, (neg_elbos, _)), g = jax.value_and_grad(loss, has_aux=True)(train)
        return l, neg_elbos, jax.flatten_util.ravel_pytree(g)[0]

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), params)
        l_s, ne_s, g_s = jax.jit(lambda tr: value_and_grad(
            parallel.sharded_loss_for_mode(mode, mesh4), tr))(params["train"])
        l_1, ne_1, g_1 = jax.jit(lambda tr: value_and_grad(
            parallel.sequential_loss_for_mode(mode, 4), tr))(params["train"])
    assert ne_s.dtype == jnp.float64
    assert len(ne_s.sharding.device_set) == 4
    onp.testing.assert_allclose(
        onp.asarray(ne_s), onp.asarray(ne_1), rtol=0, atol=1e-12
    )
    onp.testing.assert_allclose(float(l_s), float(l_1), rtol=1e-12)
    onp.testing.assert_allclose(
        onp.asarray(g_s), onp.asarray(g_1), rtol=1e-10, atol=1e-12
    )


def test_sharded_training_step_runs(mesh):
    """One jitted grad+update step over the mesh (the real training path)."""
    import optax

    target = std_normal_target(2)
    setup = bounds.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=8, emb_dim=8)
    trainable = bounds.default_trainable(setup.mode)
    params, ctx = bounds.initialize(
        setup, target.log_prob, eps=0.05, trainable=trainable
    )
    loss_fn = parallel.sharded_loss_for_mode(setup.mode, mesh)
    opt = optax.chain(optax.clip(5.0), optax.adam(1e-3))
    opt_state = opt.init(params["train"])

    @jax.jit
    def step(train_p, opt_state, key):
        def loss(tr):
            return loss_fn(
                {"train": tr, "notrain": params["notrain"]}, key, 512, ctx, setup
            )

        (l, _), grads = jax.value_and_grad(loss, has_aux=True)(train_p)
        updates, opt_state = opt.update(grads, opt_state, train_p)
        return optax.apply_updates(train_p, updates), opt_state, l

    train_p, opt_state, l = step(params["train"], opt_state, jax.random.PRNGKey(0))
    assert bool(jnp.isfinite(l))
    flat, _ = jax.flatten_util.ravel_pytree(train_p)
    assert bool(jnp.all(jnp.isfinite(flat)))
