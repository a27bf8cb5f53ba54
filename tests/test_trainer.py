"""Trainer, MFVI, and evaluation tests."""

import jax
import jax.numpy as jnp
import numpy as onp

from cmcd_tpu import bounds
from cmcd_tpu.train import evaluate, mfvi_pretrain, project, train
from cmcd_tpu.targets.base import Target


def shifted_normal_target(dim=3, mean=2.0):
    def log_prob(z):
        return -0.5 * jnp.sum((z - mean) ** 2 + jnp.log(2 * jnp.pi), axis=-1)

    return Target(name="shifted", dim=dim, log_prob=log_prob)


def test_project_constraints():
    p = {
        "eps": jnp.asarray(0.9),
        "eta": jnp.asarray(-0.5),
        "gamma": jnp.asarray(-1.0),
        "mgridref_y": jnp.array([-0.5, 0.2]),
    }
    out = project(p, ("eps", "eta", "gamma", "mgridref_y"))
    assert float(out["eps"]) == 0.5
    assert float(out["eta"]) == 0.0
    onp.testing.assert_allclose(float(out["gamma"]), 0.001, rtol=1e-6)
    assert (onp.asarray(out["mgridref_y"]) >= 0.001).all()


def test_mfvi_pretrain_finds_target_mean():
    target = shifted_normal_target(dim=3, mean=2.0)
    vd, elbo, result = mfvi_pretrain(
        3, target.log_prob, lr=0.05, iters=800, batch_size=32,
        key=jax.random.PRNGKey(0),
    )
    assert not result.diverged
    onp.testing.assert_allclose(onp.asarray(vd["mean"]), 2.0, atol=0.15)
    # MFVI on a Gaussian target is exact: ELBO -> 0.
    assert elbo > -0.1


def test_train_improves_elbo_and_projects():
    target = shifted_normal_target(dim=2, mean=1.0)
    setup = bounds.CMCDSetup(mode="MCD_CAIS_sn", dim=2, nbridges=4, emb_dim=8)
    trainable = bounds.default_trainable(setup.mode)
    params, ctx = bounds.initialize(
        setup, target.log_prob, eps=0.05, trainable=trainable
    )
    result = train(
        setup, params, ctx,
        lr=5e-3, iters=400, batch_size=64,
        key=jax.random.PRNGKey(1), trainable=trainable,
    )
    assert not result.diverged
    assert result.steps_done == 400
    losses = onp.asarray(result.losses)
    assert losses[-1] < losses[0]
    eps = float(result.params["train"]["eps"])
    assert 1e-7 <= eps <= 0.5


def test_inf_loss_trains_through_like_reference():
    """The divergence guard checks isNAN, not isfinite, on the losses
    (reference src/opt.py:122): targets with a hard log-prob floor
    (many_gmm lp <= -1e4 -> -inf) make the loss VALUE inf while its
    gradient stays finite, and the reference's published many_gmm KL
    recipes train straight through that. An inf loss must NOT abort."""
    target = shifted_normal_target(dim=2)

    def inf_loss(params, key, n, ctx, setup):
        # Finite theta-dependent part + a constant -inf floor on most
        # chains: loss value inf, gradient finite (jnp.mean routes zero
        # cotangent through the inf constants).
        finite = jnp.sum(params["train"]["eps"] ** 2)
        neg = jnp.full((n,), jnp.inf).at[0].set(finite)
        return jnp.mean(neg), (neg, jnp.zeros((n, 2)))

    setup = bounds.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=2)
    params, ctx = bounds.initialize(setup, target.log_prob, eps=0.3,
                                    trainable=("eps",))
    result = train(
        setup, params, ctx,
        lr=1e-2, iters=20, batch_size=8,
        key=jax.random.PRNGKey(0), trainable=("eps",),
        loss_fn=inf_loss, nan_check_every=1,
    )
    assert not result.diverged
    assert result.steps_done == 20
    # The finite gradient actually moved eps (d/d eps of eps^2 > 0).
    assert float(result.params["train"]["eps"]) < 0.3


def test_nan_guard_stops_and_returns_last_finite():
    target = shifted_normal_target(dim=2)

    def exploding_loss(params, key, n, ctx, setup):
        # Diverges immediately via a huge LR on a cubic loss; simpler: NaN.
        return jnp.asarray(jnp.nan), (jnp.full((n,), jnp.nan), jnp.zeros((n, 2)))

    setup = bounds.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=2)
    params, ctx = bounds.initialize(setup, target.log_prob, trainable=("eps",))
    result = train(
        setup, params, ctx,
        lr=1e-2, iters=50, batch_size=8,
        key=jax.random.PRNGKey(0), trainable=("eps",),
        loss_fn=exploding_loss, nan_check_every=1,
    )
    assert result.diverged
    assert result.steps_done < 50
    # Params structure intact.
    assert "eps" in result.params["train"]


def test_ema_tracks_params():
    target = shifted_normal_target(dim=2)
    setup = bounds.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=2)
    params, ctx = bounds.initialize(setup, target.log_prob, eps=0.01, trainable=("eps", "vd"))
    result = train(
        setup, params, ctx,
        lr=1e-2, iters=100, batch_size=16,
        key=jax.random.PRNGKey(2), trainable=("eps", "vd"), use_ema=True,
    )
    assert result.ema_params is not None
    ema_mean = onp.asarray(result.ema_params["train"]["vd"]["mean"])
    cur_mean = onp.asarray(result.params["train"]["vd"]["mean"])
    # EMA moved off init (zeros) but lags the live params.
    assert onp.abs(ema_mean).sum() > 0
    assert onp.abs(ema_mean).sum() < onp.abs(cur_mean).sum()


def test_callback_cadence_independent_of_log_every():
    """callback must fire every callback_every steps even when log_every does
    not divide it (VERDICT round 1 weak #2: LCM-cadence bug)."""
    target = shifted_normal_target(dim=2)
    setup = bounds.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=2)
    params, ctx = bounds.initialize(setup, target.log_prob, eps=0.01, trainable=("eps",))
    seen = []
    train(
        setup, params, ctx,
        lr=1e-3, iters=150, batch_size=8,
        key=jax.random.PRNGKey(0), trainable=("eps",),
        log_every=7, callback_every=75,
        callback=lambda step, info, z: seen.append(step),
    )
    assert seen == [0, 75]


def test_track_last_losses_ring():
    target = shifted_normal_target(dim=2)
    setup = bounds.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=2)
    params, ctx = bounds.initialize(setup, target.log_prob, eps=0.01, trainable=("eps",))
    result = train(
        setup, params, ctx,
        lr=1e-3, iters=40, batch_size=8,
        key=jax.random.PRNGKey(0), trainable=("eps",),
        track_last_losses=16,
    )
    ring = onp.asarray(result.last_losses)
    assert ring.shape == (16,)
    assert onp.isfinite(ring).all()  # fully populated after 40 > 16 iters


def test_checkpoint_kill_and_resume_reproduces_run(tmp_path):
    """Resume must restore params + opt state + PRNG key so the resumed run
    equals the uninterrupted one exactly (VERDICT round 1 #4)."""
    from cmcd_tpu.utils.checkpoint import CheckpointManager

    target = shifted_normal_target(dim=2, mean=1.0)
    setup = bounds.CMCDSetup(mode="MCD_CAIS_sn", dim=2, nbridges=4, emb_dim=8)
    trainable = bounds.default_trainable(setup.mode)
    params, ctx = bounds.initialize(
        setup, target.log_prob, eps=0.05, trainable=trainable
    )
    kw = dict(lr=5e-3, batch_size=32, trainable=trainable, use_ema=True)

    # Uninterrupted run: 60 iters.
    full = train(setup, params, ctx, iters=60, key=jax.random.PRNGKey(7), **kw)

    # Interrupted: checkpoint lands at step 30 mid-run; the process is then
    # "killed" (a raising callback aborts the loop before any final save).
    class Killed(Exception):
        pass

    def killer(step, info, z):
        if step >= 32:
            raise Killed()

    ckpt2 = CheckpointManager(str(tmp_path / "ckpt2"))
    import pytest

    with pytest.raises(Killed):
        train(
            setup, params, ctx, iters=60, key=jax.random.PRNGKey(7),
            checkpoint=ckpt2, checkpoint_every=30,
            callback=killer, callback_every=1, **kw
        )
    assert ckpt2.latest_step() == 30
    resumed = train(
        setup, params, ctx, iters=60, key=jax.random.PRNGKey(7),
        checkpoint=ckpt2, resume=True, **kw
    )
    assert resumed.steps_done == 60

    for a, b in zip(
        jax.tree_util.tree_leaves(full.params),
        jax.tree_util.tree_leaves(resumed.params),
    ):
        onp.testing.assert_allclose(onp.asarray(a), onp.asarray(b), atol=1e-6)
    for a, b in zip(
        jax.tree_util.tree_leaves(full.ema_params),
        jax.tree_util.tree_leaves(resumed.ema_params),
    ):
        onp.testing.assert_allclose(onp.asarray(a), onp.asarray(b), atol=1e-6)


def test_chunked_steps_match_single_steps():
    """steps_per_call > 1 (lax.scan of updates inside one jit) must produce
    the same params and per-step loss stream as the per-step host loop — the
    key splits happen in the same order either way."""
    target = shifted_normal_target(dim=2, mean=1.0)
    setup = bounds.CMCDSetup(mode="MCD_CAIS_sn", dim=2, nbridges=4, emb_dim=8)
    trainable = bounds.default_trainable(setup.mode)
    params, ctx = bounds.initialize(
        setup, target.log_prob, eps=0.05, trainable=trainable
    )
    kw = dict(
        lr=5e-3, iters=60, batch_size=32, trainable=trainable,
        log_every=5, track_last_losses=12,
    )
    a = train(setup, params, ctx, key=jax.random.PRNGKey(3), steps_per_call=1, **kw)
    b = train(setup, params, ctx, key=jax.random.PRNGKey(3), steps_per_call=10, **kw)
    onp.testing.assert_allclose(
        onp.asarray(a.losses), onp.asarray(b.losses), rtol=1e-6
    )
    onp.testing.assert_allclose(
        onp.asarray(a.last_losses), onp.asarray(b.last_losses), rtol=1e-6
    )
    for x, y in zip(
        jax.tree_util.tree_leaves(a.params), jax.tree_util.tree_leaves(b.params)
    ):
        onp.testing.assert_allclose(onp.asarray(x), onp.asarray(y), atol=1e-6)


def test_eps_schedule_ignored_outside_cais_modes():
    """Reference dispatch passes no eps schedule to non-CAIS integrators
    (src/mcd_utils.py); a ULA setup must produce schedule-invariant output."""
    target = shifted_normal_target(dim=2)
    outs = []
    for sched in ("", "cos_sq"):
        setup = bounds.CMCDSetup(
            mode="MCD_ULA", dim=2, nbridges=4, eps_schedule=sched
        )
        assert setup.eps_schedule == ""
        params, ctx = bounds.initialize(setup, target.log_prob, eps=0.05, trainable=("eps",))
        neg_elbos, z = bounds.compute_elbos(params, jax.random.PRNGKey(0), 32, ctx, setup)
        outs.append(onp.asarray(neg_elbos))
    onp.testing.assert_array_equal(outs[0], outs[1])
    # CAIS modes keep the schedule.
    s = bounds.CMCDSetup(mode="MCD_CAIS_sn", dim=2, nbridges=4, eps_schedule="cos_sq")
    assert s.eps_schedule == "cos_sq"


def test_evaluate_protocol():
    target = shifted_normal_target(dim=2, mean=0.0)
    setup = bounds.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=4)
    params, ctx = bounds.initialize(setup, target.log_prob, eps=0.01, trainable=("eps",))
    out = evaluate(
        params, ctx, setup, key=jax.random.PRNGKey(3),
        n_samples=200, n_input_dist_seeds=5,
    )
    assert out["neg_elbos"].shape == (5, 200)
    assert out["samples"].shape == (1000, 2)
    # Gaussian target with matched q: lnZ ~ 0 tightly.
    assert abs(out["final_ln_Z"]) < 0.05
    assert out["final_elbo"] <= 0.01


def test_train_times_each_jitted_call():
    """One host-clock entry per jitted call; the first includes compilation,
    which chip_smoke.py reads as first minus a steady call."""
    target = shifted_normal_target(dim=2, mean=1.0)
    setup = bounds.CMCDSetup(mode="MCD_ULA", dim=2, nbridges=2)
    params, ctx = bounds.initialize(setup, target.log_prob, eps=0.05)
    result = train(
        setup, params, ctx, lr=1e-3, iters=12, batch_size=8,
        key=jax.random.PRNGKey(0), trainable=("eps",), steps_per_call=4,
    )
    assert result.steps_per_call == 4
    assert len(result.chunk_seconds) == 3
    assert all(t > 0 for t in result.chunk_seconds)
    assert result.chunk_seconds[0] > result.chunk_seconds[-1]
