"""Benchmark: annealed-SDE chain-steps/sec on one GPU, flagship recipe.

Config: 40-mode GMM, N=2000 chains, nbridges=256, geffner score net at the
published width emb_dim=130 — the reference's headline VarGrad recipe
(README.md:26-40, BASELINE.json). One "chain-step" is one SDE bridge step of
one chain, so a training step performs N * nbridges chain-steps (the
backward pass and the Adam update are part of the measured step).

Measured, each as the median of `repeats` groups of chained steps, timed on
the host clock around jax.block_until_ready:
- the VarGrad (MCD_CAIS_var_sn) train step, chunked like the trainer
  (steps_per_call steps per jitted call), and unchunked;
- the KL (MCD_CAIS_sn, full BPTT) train step;
- one evaluation forward pass (compute_elbos);
- the reference-style VarGrad step (bench_reference_style.py): the
  reference's vmapped per-chain execution structure on the same card. The
  reference itself cannot run here (numpyro/distrax/wandb absent).

Prints ONE JSON line:
  {"metric": "chain_steps_per_sec_per_chip", "value": ..., "unit": ...,
   "vs_baseline": ..., "detail": {...}}
vs_baseline = VarGrad step throughput / reference-style throughput. The
detail names the device (platform, device_kind, count) and the card's name
and power limit. Exits nonzero, with no result, when JAX finds no GPU.

Env knobs: BENCH_N, BENCH_NBRIDGES, BENCH_EMB_DIM, BENCH_ITERS,
BENCH_REPEATS, BENCH_STEPS_PER_CALL.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import optax


def time_steps(step_fn, init_state, iters: int, repeats: int = 3):
    """Per-call wall-clock: `repeats` groups of `iters` chained calls, each
    group ended by jax.block_until_ready. step_fn must be compiled already
    or compile on its first call (two warm-up calls precede the groups).

    Returns (median_of_group_means, group_means list)."""
    state = jax.block_until_ready(step_fn(init_state))
    state = jax.block_until_ready(step_fn(state))

    means = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            state = step_fn(state)
        jax.block_until_ready(state)
        means.append((time.perf_counter() - t0) / iters)
    return sorted(means)[len(means) // 2], means


def _flagship_problem(mode, nbridges, emb_dim):
    import cmcd_tpu

    target = cmcd_tpu.load_target("many_gmm")
    setup = cmcd_tpu.CMCDSetup(
        mode=mode,
        dim=target.dim,
        nbridges=nbridges,
        emb_dim=emb_dim,
        grad_clipping=True,
    )
    trainable = cmcd_tpu.default_trainable(setup.mode, train_eps=False, train_vi=False)
    params, ctx = cmcd_tpu.initialize(
        setup, target.log_prob, eps=0.65, init_sigma=15.0, trainable=trainable
    )
    return setup, trainable, params, ctx


def _train_step_factory(loss_builder, trainable):
    from cmcd_tpu.train import project

    opt = optax.chain(optax.clip(5.0), optax.adam(1e-3))

    def train_step(state):
        train_p, notrain, opt_state, key = state
        key, step_key = jax.random.split(key)

        def loss(tr):
            return loss_builder({"train": tr, "notrain": notrain}, step_key)

        (l, _), grads = jax.value_and_grad(loss, has_aux=True)(train_p)
        updates, opt_state = opt.update(grads, opt_state, train_p)
        train_p = optax.apply_updates(train_p, updates)
        train_p = project(train_p, trainable)
        return (train_p, notrain, opt_state, key)

    return train_step, opt


def bench_train(mode, n, nbridges, emb_dim, iters, repeats, steps_per_call=1):
    """Per-step time of the training loop main.py runs, optionally with the
    trainer's step chunking (steps_per_call updates per jitted call,
    train/trainer.py)."""
    import cmcd_tpu
    from cmcd_tpu.utils import const_hoisted_jit

    setup, trainable, params, ctx = _flagship_problem(mode, nbridges, emb_dim)
    loss_fn = cmcd_tpu.loss_fn_for_mode(mode)
    loss_builder = lambda p, k: loss_fn(p, k, n, ctx, setup)

    train_step, opt = _train_step_factory(loss_builder, trainable)
    if steps_per_call > 1:
        inner = train_step

        def train_step(state):
            return jax.lax.scan(
                lambda s, _: (inner(s), None), state, None, length=steps_per_call
            )[0]

    state = (
        params["train"],
        params["notrain"],
        opt.init(params["train"]),
        jax.random.PRNGKey(0),
    )
    step = const_hoisted_jit(train_step, state)
    t, groups = time_steps(step, state, iters, repeats)
    return t / steps_per_call, [g / steps_per_call for g in groups]


def bench_eval(n, nbridges, emb_dim, iters, repeats):
    """Forward (evaluation) time of one compute_elbos call on N chains."""
    import cmcd_tpu
    from cmcd_tpu.utils import const_hoisted_jit

    setup, _, params, ctx = _flagship_problem("MCD_CAIS_var_sn", nbridges, emb_dim)

    def step(state):
        key, acc = state
        key, sk = jax.random.split(key)
        ne, _ = cmcd_tpu.compute_elbos(params, sk, n, ctx, setup)
        return key, acc + jnp.mean(ne)

    state = (jax.random.PRNGKey(0), jnp.float32(0.0))
    return time_steps(const_hoisted_jit(step, state), state, iters, repeats)


def bench_reference_style(n, nbridges, emb_dim, iters, repeats):
    import cmcd_tpu
    from cmcd_tpu.networks.geffner import build_geffner_network
    from cmcd_tpu.schedules import betas_from_grid, make_beta_grid_params
    from bench_reference_style import make_reference_style_vargrad

    target = cmcd_tpu.load_target("many_gmm")
    dim = target.dim

    init_sn, apply_sn_batched = build_geffner_network(dim, emb_dim, nbridges)
    sn = init_sn(jax.random.PRNGKey(1))

    def apply_sn_single(p, z, i):
        return apply_sn_batched(p, z[None, :], i)[0]

    def target_single(z):
        return target.log_prob(z[None, :])[0]

    loss_fn = make_reference_style_vargrad(target_single, dim, nbridges, apply_sn_single)
    mg, gx, tx = make_beta_grid_params(nbridges)
    params = {
        "vd": {
            "mean": jnp.zeros(dim),
            "logdiag": jnp.ones(dim) * jnp.log(15.0),
        },
        "eps": jnp.asarray(0.65),
        "sn": sn,
        "mgridref_y": mg,
        "gridref_x": gx,
        "target_x": tx,
    }
    opt = optax.chain(optax.clip(5.0), optax.adam(1e-3))
    # Reference trains (eta, gamma, sn, mgridref_y); grads flow to sn and
    # mgridref_y here — equivalent work.
    opt_state = opt.init(params)

    def train_step(state):
        params, opt_state, key = state
        key, step_key = jax.random.split(key)
        # Reference draws N integer seeds per step (src/opt.py:94).
        seeds = jax.random.randint(step_key, (n,), 1, int(1e6))

        def loss(p):
            # gridref_x/target_x are frozen buffers in the reference
            # (notrain + stop_gradient, src/mcdboundingmachine.py:113-114,142).
            b = betas_from_grid(
                p["mgridref_y"],
                jax.lax.stop_gradient(p["gridref_x"]),
                jax.lax.stop_gradient(p["target_x"]),
            )
            return loss_fn(seeds, p, b)

        (l, _), grads = jax.value_and_grad(loss, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state, key)

    from cmcd_tpu.utils import const_hoisted_jit

    state = (params, opt_state, jax.random.PRNGKey(0))
    step = const_hoisted_jit(train_step, state)
    return time_steps(step, state, iters, repeats)


def main():
    from cmcd_tpu.utils.compile_cache import enable_compile_cache
    from cmcd_tpu.utils.profiling import device_summary, gpu_name_and_power_limit

    enable_compile_cache()
    device = device_summary()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {device}")
    card = gpu_name_and_power_limit()

    n = int(os.environ.get("BENCH_N", 2000))
    nbridges = int(os.environ.get("BENCH_NBRIDGES", 256))
    emb_dim = int(os.environ.get("BENCH_EMB_DIM", 130))
    iters = int(os.environ.get("BENCH_ITERS", 20))
    repeats = int(os.environ.get("BENCH_REPEATS", 3))
    # 100 matches the trainer's automatic steps_per_call (largest divisor of
    # iters <= 100).
    chunk = int(os.environ.get("BENCH_STEPS_PER_CALL", 100))

    def ms(t):
        return t * 1e3

    t_var, var_groups = bench_train(
        "MCD_CAIS_var_sn", n, nbridges, emb_dim, max(iters // chunk, 3),
        repeats, steps_per_call=chunk,
    )
    t_var_1, _ = bench_train(
        "MCD_CAIS_var_sn", n, nbridges, emb_dim, iters, repeats
    )
    t_kl, kl_groups = bench_train(
        "MCD_CAIS_sn", n, nbridges, emb_dim, max(iters // chunk, 3), repeats,
        steps_per_call=chunk,
    )
    t_eval, eval_groups = bench_eval(n, nbridges, emb_dim, iters, repeats)
    t_ref, ref_groups = bench_reference_style(
        n, nbridges, emb_dim, max(iters // 2, 5), repeats
    )

    chain_steps = n * nbridges
    print(json.dumps({
        "metric": "chain_steps_per_sec_per_chip",
        "value": chain_steps / t_var,
        "unit": "chain-steps/s",
        "vs_baseline": t_ref / t_var,
        "detail": {
            "config": (
                f"many_gmm N={n} K={nbridges} emb_dim={emb_dim} geffner"
            ),
            "iters_per_group": iters,
            "repeats": repeats,
            "steps_per_call": chunk,
            "vargrad_train_step_ms": ms(t_var),
            "vargrad_train_group_means_ms": [ms(t) for t in var_groups],
            "vargrad_train_unchunked_step_ms": ms(t_var_1),
            "kl_train_step_ms": ms(t_kl),
            "kl_train_group_means_ms": [ms(t) for t in kl_groups],
            "eval_forward_ms": ms(t_eval),
            "eval_group_means_ms": [ms(t) for t in eval_groups],
            "eval_chain_steps_per_s": chain_steps / t_eval,
            "reference_style_step_ms": ms(t_ref),
            "reference_style_group_means_ms": [ms(t) for t in ref_groups],
            "device": device,
            "card": card,
        },
    }))


if __name__ == "__main__":
    main()
