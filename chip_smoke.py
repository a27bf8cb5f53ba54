"""Smoke test: CMCD trains and evaluates on one GPU through its entry points.

Runs in one process, phase by phase; each phase prints one line saying what
it checked and what it measured, and any failure exits nonzero at once.

  1. Device: JAX's first device is a GPU; prints its kind, the device count
     and the card's name and power limit (nvidia-smi).
  2. Flagship VarGrad training through cmcd_tpu.main.run_experiment: the
     many_gmm_vargrad recipe (40-mode GMM, MCD_CAIS_var_sn, N=2000, K=256,
     emb_dim=130) cut to 200 steps and 2 evaluation seed groups.
  3. Flagship KL training with the PIS ("dds") net: the many_gmm_kl_dds
     recipe (MCD_CAIS_sn, full BPTT, N=2000, K=256) cut to 200 steps.
  4. The largest target: 1600-D lgcp, MCD_CAIS_sn, N=128, K=256,
     emb_dim=20, no MFVI pretraining, 100 steps.
  5. Precision and correctness against the plain reference, the same scan
     under jax.default_matmul_precision("highest") with the same key:
     (a) the trained flagship's per-chain neg-ELBOs, ln Z and VarGrad
     gradient at the program's default precision; (b) the same for 64
     chains at "highest" against the CPU backend; (c) the lgcp log-density
     and its gradient at 1600-D on 128 points; (d) the same for the
     logistic-regression targets (sonar, ionosphere).
  6. --four only (and then no phase but 1): on four GPUs, the chain-sharded
     train loss main.py builds (parallel.sharded_loss_for_mode) for the
     flagship and lgcp, against the same four chain shards computed one
     after another on one card (parallel.sequential_loss_for_mode).

Phases 2-4 print the compile time (first call minus a steady call), the
steady step time (host clock around jax.block_until_ready) and the
process's peak device memory so far. The last line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

# Training phases: a published recipe (experiments/recipes.py) and what the
# smoke run changes in it.
FLAGSHIP_VARGRAD = ("many_gmm_vargrad", {"iters": 200, "n_input_dist_seeds": 2})
FLAGSHIP_KL_DDS = ("many_gmm_kl_dds", {"iters": 200, "n_input_dist_seeds": 2})
LGCP = (None, {
    "model": "lgcp", "boundmode": "MCD_CAIS_sn", "N": 128, "nbridges": 256,
    "emb_dim": 20, "pretrain_mfvi": False, "iters": 100,
    "steps_per_call": 50, "n_input_dist_seeds": 2,
})

# Phase 5 limits. Default precision may run float32 products in TF32 (about
# three decimal digits), hence 1e-2 against "highest"; the GPU and the CPU
# at "highest" differ only in summation order and in the transcendental
# functions' last bits, hence 1e-4.
LNZ_TOL = 1e-2
DEFAULT_REL_TOL = 1e-2
CPU_REL_TOL = 1e-4
LOGPROB_REL_TOL = 1e-4
# Phase 6 limit: both sides run in float64, because in float32 a gradient
# that is a sum with heavy cancellation (d/d eps at eps=1e-5 sums terms of
# order 1/eps) moves by ~1e-2 with the summation order alone; the sharded
# side sums over four devices in another order than the one-card side.
SHARD_REL_TOL = 1e-7


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def fail(phase, msg):
    print(f"[phase {phase}] FAIL: {msg}", flush=True)
    sys.exit(1)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def ln_z(neg_elbos):
    from scipy.special import logsumexp

    ne = np.asarray(neg_elbos, np.float64)
    return float(logsumexp(-ne) - np.log(ne.shape[0]))


def recipe_config(recipe, changes):
    from cmcd_tpu.config import apply_lookup_tables, get_config
    from experiments.recipes import RECIPES

    config = get_config()
    flags = dict(RECIPES[recipe]["flags"]) if recipe else {}
    flags.update(changes)
    for k, v in flags.items():
        if k not in config:
            raise KeyError(f"unknown config field {k!r}")
        setattr(config, k, v)
    for k, v in apply_lookup_tables(config).items():
        setattr(config, k, v)
    return config


def phase_device(n_cards):
    import jax

    from cmcd_tpu.utils.profiling import device_summary, gpu_name_and_power_limit

    device = device_summary()
    if device["platform"] != "gpu":
        fail(1, f"JAX's first device is not a GPU: {device}")
    if device["count"] != n_cards:
        fail(1, f"expected {n_cards} GPU(s), JAX sees {device['count']}")
    card = gpu_name_and_power_limit()
    say(1, f"device_kind={device['kind']} count={device['count']} "
           f"jax={jax.__version__}")
    print(f"nvidia-smi name,power.limit: {card}", flush=True)
    return device


def phase_train(phase, label, config):
    """Train and evaluate through run_experiment; check and time it."""
    import jax

    from cmcd_tpu.main import run_experiment

    t0 = time.perf_counter()
    results = run_experiment(config)
    wall = time.perf_counter() - t0
    tr = results["train"]
    losses = np.asarray(tr.losses)
    if tr.diverged or tr.steps_done != config.iters:
        fail(phase, f"{label}: stopped at step {tr.steps_done} of {config.iters}")
    # The trainer's own rule: a loss must never be NaN. many_gmm's log-density
    # floor (targets/gmm.py) makes a KL loss +inf while a chain sits in the
    # floored region, with a finite gradient, so early losses may be +inf;
    # the last one must be finite.
    n_nonfinite = int((~np.isfinite(losses)).sum())
    if np.isnan(losses).any() or not np.isfinite(losses[-1]):
        fail(phase, f"{label}: losses not finite: {losses[-5:]}")
    elbo, lnz = results["final_elbo"], results["final_ln_Z"]
    if not (math.isfinite(elbo) and math.isfinite(lnz)):
        fail(phase, f"{label}: ELBO {elbo} ln Z {lnz}")
    cs = tr.chunk_seconds
    if len(cs) < 2:
        fail(phase, f"{label}: need two jitted calls to time a steady one")
    step_ms = cs[-1] / tr.steps_per_call * 1e3
    compile_s = cs[0] - cs[-1]
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", "not measured")
    say(phase, f"{label}: {tr.steps_done} steps ok, loss {losses[0]:.4g} -> "
               f"{losses[-1]:.6g} ({n_nonfinite} non-finite), ELBO {elbo:.6g}, "
               f"ln Z {lnz:.6g} | compile {compile_s:.3f} s, steady step "
               f"{step_ms:.4f} ms ({tr.steps_per_call} steps/call), process "
               f"peak device memory {peak} B, phase wall {wall:.3f} s")
    return results


def _vargrad_eval(params, key, n, ctx, setup):
    """Per-chain neg-ELBOs and the flattened loss gradient of the trainable
    params, jitted anew so each precision context compiles its own."""
    import jax

    from cmcd_tpu import bounds

    loss_fn = bounds.loss_fn_for_mode(setup.mode)

    def f(train, notrain):
        def loss(tr):
            return loss_fn({"train": tr, "notrain": notrain}, key, n, ctx, setup)

        (_, (ne, _)), g = jax.value_and_grad(loss, has_aux=True)(train)
        return ne, jax.flatten_util.ravel_pytree(g)[0]

    return jax.jit(f)(params["train"], params["notrain"])


def phase_precision(config, trained_params, n_cpu=64, lgcp_points=128):
    import jax
    import jax.flatten_util  # noqa: F401
    import jax.numpy as jnp

    from cmcd_tpu import bounds
    from cmcd_tpu.main import make_setup
    from cmcd_tpu.targets import load_target

    target = load_target(config.model, config)
    setup = make_setup(config, target.dim)
    _, ctx = bounds.initialize(setup, target.log_prob)
    key = jax.random.PRNGKey(7)
    rows = []  # (what, measured, limit)

    # (a) default precision against "highest", on the card, flagship width.
    ne_d, g_d = _vargrad_eval(trained_params, key, config.N, ctx, setup)
    with jax.default_matmul_precision("highest"):
        ne_h, g_h = _vargrad_eval(trained_params, key, config.N, ctx, setup)
    rows += [
        (f"(a) N={config.N} ln Z default vs highest [nats]",
         abs(ln_z(ne_d) - ln_z(ne_h)), LNZ_TOL),
        ("(a) per-chain neg-ELBO rel L2 default vs highest",
         rel_l2(ne_d, ne_h), DEFAULT_REL_TOL),
        ("(a) VarGrad gradient rel L2 default vs highest",
         rel_l2(g_d, g_h), DEFAULT_REL_TOL),
    ]

    # (b) "highest" on the card against "highest" on the CPU backend.
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        ne_g, g_g = _vargrad_eval(trained_params, key, n_cpu, ctx, setup)
        with jax.default_device(cpu):
            ne_c, g_c = _vargrad_eval(
                jax.device_put(trained_params, cpu), jax.device_put(key, cpu),
                n_cpu, ctx, setup,
            )
    if next(iter(ne_c.devices())).platform != "cpu":
        fail(5, "the CPU reference did not run on the CPU")
    rows += [
        (f"(b) N={n_cpu} ln Z gpu vs cpu [nats]",
         abs(ln_z(ne_g) - ln_z(ne_c)), LNZ_TOL),
        ("(b) per-chain neg-ELBO rel L2 gpu vs cpu",
         rel_l2(ne_g, ne_c), CPU_REL_TOL),
        ("(b) VarGrad gradient rel L2 gpu vs cpu", rel_l2(g_g, g_c), CPU_REL_TOL),
    ]

    # (c) the 1600-D lgcp and (d) the logistic-regression targets' X @ w:
    # log-density and gradient at the chains' initial distribution N(0, I),
    # default against "highest".
    for tag, name in (("(c)", "lgcp"), ("(d)", "log_sonar"),
                      ("(d)", "log_ionosphere")):
        tgt = load_target(name)
        z = jax.random.normal(jax.random.PRNGKey(3), (lgcp_points, tgt.dim))

        def lp_and_grad(z, tgt=tgt):
            lp = tgt.log_prob(z)
            return lp, jax.grad(lambda zz: jnp.sum(tgt.log_prob(zz)))(z)

        lp_d, gz_d = jax.jit(lp_and_grad)(z)
        with jax.default_matmul_precision("highest"):
            lp_h, gz_h = jax.jit(lambda zz: lp_and_grad(zz))(z)
        lp_d, lp_h = np.asarray(lp_d, np.float64), np.asarray(lp_h, np.float64)
        rows += [
            (f"{tag} {name} log_prob max rel diff default vs highest "
             f"({lgcp_points} pts)",
             float(np.max(np.abs(lp_d - lp_h) / np.abs(lp_h))), LOGPROB_REL_TOL),
            (f"{tag} {name} gradient rel L2 default vs highest",
             rel_l2(gz_d, gz_h), DEFAULT_REL_TOL),
        ]

    bad = []
    for what, value, limit in rows:
        ok = math.isfinite(value) and value <= limit
        say(5, f"{what}: {value:.3e} (limit {limit:.0e}) {'ok' if ok else 'EXCEEDED'}")
        if not ok:
            bad.append(what)
    if bad:
        fail(5, f"{len(bad)} difference(s) over their limit: {bad}")


def phase_four(label, config, n_shards=4):
    """Sharded train loss and gradient on n_shards devices against the same
    shards computed one after another on one device."""
    import jax

    from cmcd_tpu import bounds, parallel
    from cmcd_tpu.main import make_setup
    from cmcd_tpu.targets import load_target

    target = load_target(config.model, config)
    setup = make_setup(config, target.dim)
    trainable = bounds.default_trainable(
        setup.mode, config.train_eps, config.train_vi, config.train_betas
    )
    params, ctx = bounds.initialize(
        setup, target.log_prob, eps=config.init_eps, eta=config.init_eta,
        gamma=config.init_gamma, trainable=trainable,
        init_sigma=config.init_sigma, seed=config.seed,
    )
    mesh = parallel.make_chain_mesh(n_shards)
    key = jax.random.PRNGKey(11)

    def value_and_grad(loss_fn, params):
        def f(train):
            def loss(tr):
                return loss_fn({"train": tr, "notrain": params["notrain"]},
                               key, config.N, ctx, setup)

            (l, (ne, _)), g = jax.value_and_grad(loss, has_aux=True)(train)
            return l, ne, jax.flatten_util.ravel_pytree(g)[0]

        return jax.jit(f)

    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        params = jax.tree_util.tree_map(lambda x: x.astype(np.float64), params)
        t0 = time.perf_counter()
        l_s, ne_s, g_s = jax.block_until_ready(value_and_grad(
            parallel.sharded_loss_for_mode(setup.mode, mesh), params,
        )(params["train"]))
        t_sharded = time.perf_counter() - t0
        t0 = time.perf_counter()
        l_1, ne_1, g_1 = jax.block_until_ready(value_and_grad(
            parallel.sequential_loss_for_mode(setup.mode, n_shards), params,
        )(jax.device_put(params["train"], jax.devices()[0])))
        t_seq = time.perf_counter() - t0
    if len(ne_s.sharding.device_set) != n_shards:
        fail(6, f"{label}: chains not sharded over {n_shards} devices")
    rows = [
        ("loss rel diff", abs(float(l_s) - float(l_1)) / max(abs(float(l_1)), 1e-30)),
        ("per-chain neg-ELBO rel L2", rel_l2(ne_s, ne_1)),
        ("gradient rel L2", rel_l2(g_s, g_1)),
    ]
    msg = ", ".join(f"{w} {v:.3e}" for w, v in rows)
    say(6, f"{label} N={config.N} float64 on {n_shards} devices vs one: loss "
           f"{float(l_s):.6g} vs {float(l_1):.6g}; {msg} (limit "
           f"{SHARD_REL_TOL:.0e}); first call incl. compile: sharded "
           f"{t_sharded:.3f} s, sequential {t_seq:.3f} s")
    if not all(math.isfinite(v) and v <= SHARD_REL_TOL for _, v in rows):
        fail(6, f"{label}: sharded and per-shard results differ")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharding check (phase 6)")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1

    import jax

    # One card unless --four, even where the machine has more.
    jax.config.update("jax_cuda_visible_devices",
                      ",".join(str(i) for i in range(n_cards)))
    # Phase 5 needs the CPU backend beside the GPU.
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    import jax.flatten_util  # noqa: F401

    from cmcd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = phase_device(n_cards)

    if args.four:
        phase_four("flagship VarGrad", recipe_config(
            FLAGSHIP_VARGRAD[0], FLAGSHIP_VARGRAD[1]))
        phase_four("lgcp KL", recipe_config(*LGCP))
    else:
        vargrad_config = recipe_config(*FLAGSHIP_VARGRAD)
        results = phase_train(2, "flagship VarGrad (many_gmm_vargrad)",
                              vargrad_config)
        phase_train(3, "flagship KL dds (many_gmm_kl_dds)",
                    recipe_config(*FLAGSHIP_KL_DDS))
        phase_train(4, "lgcp 1600-D KL", recipe_config(*LGCP))
        phase_precision(vargrad_config, results["train"].params)

    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
