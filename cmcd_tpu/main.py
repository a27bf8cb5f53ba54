"""Experiment driver CLI.

Reference: src/main.py. Same flag surface (--config.model, --config.boundmode,
--config.N, --config.nbridges, ...; parsed by cmcd_tpu.config.parse_flags),
same phases: [MFVI pretrain] -> mode init -> train -> eval (30x500) -> W2 for
tractable targets -> artifact dump. New capabilities: chain sharding over
every visible device, periodic checkpointing + resume, JSONL metrics, no
wandb requirement.

Run e.g.:
  python -m cmcd_tpu.main --config.model funnel --config.boundmode MCD_CAIS_sn \
      --config.nbridges 8 --config.N 300 --config.iters 11000
"""

from __future__ import annotations

import os
import pickle
import sys

import jax

from cmcd_tpu import bounds
from cmcd_tpu.config import apply_lookup_tables, parse_flags
from cmcd_tpu.targets import load_target
from cmcd_tpu.train import evaluate, mfvi_pretrain, train
from cmcd_tpu.utils import MetricLogger, ThroughputMeter, calculate_w2_distances
from cmcd_tpu.utils.compile_cache import enable_compile_cache


def make_setup(config, dim: int) -> bounds.CMCDSetup:
    """The bound's static configuration from the config's fields."""
    return bounds.CMCDSetup(
        mode=config.boundmode,
        dim=dim,
        nbridges=config.nbridges,
        eps_schedule=config.eps_schedule,
        grad_clipping=config.grad_clipping,
        lfsteps=config.lfsteps,
        remat_steps=config.remat_steps,
        emb_dim=config.emb_dim,
        nlayers=config.nlayers,
        nn_arch=config.nn_arch,
        fully_connected_units=tuple(config.fully_connected_units),
    )


def run_experiment(config, logger: MetricLogger | None = None):
    logger = logger or MetricLogger(config.log.jsonl)
    for k, v in apply_lookup_tables(config).items():
        setattr(config, k, v)
    print(config)

    target = load_target(config.model, config)
    dim = target.dim
    key = jax.random.PRNGKey(config.seed)
    train_key, eval_key = jax.random.split(key)

    # ---- MFVI pretrain (reference main.py:82-113) -----------------------
    if config.pretrain_mfvi:
        vdparams, elbo_init, _ = mfvi_pretrain(
            dim,
            target.log_prob,
            lr=config.mfvi_lr,
            iters=config.mfvi_iters,
            batch_size=config.N,
            key=train_key,
            init_sigma=config.init_sigma,
        )
        print("Done training initial parameters, got ELBO %.2f." % elbo_init)
        logger.log({"elbo_init": elbo_init})
    else:
        from cmcd_tpu.distributions import diag_gaussian_init

        vdparams = diag_gaussian_init(dim, config.init_sigma)

    # ---- Mode init (reference main.py:115-180) ---------------------------
    mode = config.boundmode
    setup = make_setup(config, dim)
    trainable = bounds.default_trainable(
        mode, config.train_eps, config.train_vi, config.train_betas
    )
    params, ctx = bounds.initialize(
        setup,
        target.log_prob,
        vdparams=vdparams,
        eps=config.init_eps,
        eta=config.init_eta,
        gamma=config.init_gamma,
        trainable=trainable,
        seed=config.seed,
    )

    # ---- Multi-device: shard the chain axis over all devices -------------
    # (new capability vs the single-device reference, SURVEY.md §2c). Chains
    # are iid, so this is pure data parallelism over a 1-D mesh; losses and
    # ln Z reduce via XLA collectives (NCCL over NVLink between GPUs).
    train_loss_fn = None
    eval_elbo_fn = None
    if jax.device_count() > 1:
        from cmcd_tpu import parallel

        ndev = jax.device_count()
        if config.N % ndev != 0:
            raise ValueError(
                f"--config.N={config.N} must be divisible by the "
                f"{ndev} available devices for chain sharding; pick e.g. "
                f"N={config.N - config.N % ndev}"
            )
        mesh = parallel.make_chain_mesh()
        train_loss_fn = parallel.sharded_loss_for_mode(mode, mesh)
        eval_elbo_fn = lambda p, k, n: parallel.sharded_compute_elbos(
            p, k, n, ctx, setup, mesh
        )
        print(f"Sharding {config.N} chains over {ndev} devices.")

    meter = ThroughputMeter(config.N, config.nbridges)

    # Training-time visualization + W2 (reference plots samples and W2 every
    # 1% of iters, src/opt.py:109-120, src/utils.py:136-178).
    plot_w2_ref = None
    if config.plot_dir:
        from cmcd_tpu.utils import plotting

        plotting.require_matplotlib()
    if config.plot_dir and target.sample is not None:
        n_w2 = min(config.n_sinkhorn, config.N)
        plot_w2_ref = target.sample(jax.random.PRNGKey(3), n_w2)

    def callback(step, info, z):
        # The trainer supplies a per-chunk optimizer-steps/sec measured
        # between host materializations (honest under chunked dispatch);
        # convert to the chain-steps/s north-star unit here.
        info["chain_steps_per_sec"] = meter.chain_rate(
            info.pop("steps_per_sec", 0.0)
        )
        if config.plot_dir:
            from cmcd_tpu.utils import plotting

            plotting.plot_samples(
                config.model, target.log_prob, jax.device_get(z), config,
                config.plot_dir, step=step,
            )
            if plot_w2_ref is not None:
                from cmcd_tpu.utils.sinkhorn import sinkhorn_w2

                info["train_w2"] = float(
                    sinkhorn_w2(z[: plot_w2_ref.shape[0]], plot_w2_ref)
                )
        logger.log(info, step=step)

    # ---- Checkpointing (new capability) ----------------------------------
    ckpt = None
    if config.checkpoint_dir:
        from cmcd_tpu.utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(config.checkpoint_dir)

    # ---- Train ------------------------------------------------------------
    result = train(
        setup,
        params,
        ctx,
        lr=config.lr,
        iters=config.iters,
        batch_size=config.N,
        key=train_key,
        trainable=trainable,
        loss_fn=train_loss_fn,
        use_ema=config.use_ema,
        callback=callback,
        checkpoint=ckpt,
        checkpoint_every=config.checkpoint_every,
        resume=config.resume,
        profile_dir=config.profile_dir,
        steps_per_call=config.steps_per_call,
    )
    if result.diverged:
        print("Diverged at step %d; evaluating last finite params." % result.steps_done)
    params = result.params

    # (train() saved the final full-state checkpoint itself when ckpt is set.)

    # ---- Eval (reference main.py:209-246) --------------------------------
    out = evaluate(
        params,
        ctx,
        setup,
        key=eval_key,
        n_samples=config.n_samples,
        n_input_dist_seeds=config.n_input_dist_seeds,
        elbo_fn=eval_elbo_fn,
    )
    print("Done training, got ELBO %.2f." % out["final_elbo"])
    print("Done training, got ln Z %.2f." % out["final_ln_Z"])
    logger.log({k: v for k, v in out.items() if isinstance(v, float)})

    results = {
        "final_elbo": out["final_elbo"],
        "final_ln_Z": out["final_ln_Z"],
        "final_elbo_std": out["final_elbo_std"],
        "final_ln_Z_std": out["final_ln_Z_std"],
        # Raw eval arrays for downstream diagnostics (mode occupancy,
        # weight-variance/ESS probes — experiments/gmm_probe.py). Consumers
        # that serialize results filter to scalars (experiments/recipes.py
        # run_all keeps int/float only).
        "samples": out["samples"],
        "neg_elbos": out["neg_elbos"],
        # The TrainResult: per-step losses, per-call times, divergence.
        "train": result,
    }

    if config.use_ema and result.ema_params is not None:
        out_ema = evaluate(
            result.ema_params,
            ctx,
            setup,
            key=eval_key,
            n_samples=config.n_samples,
            n_input_dist_seeds=config.n_input_dist_seeds,
            elbo_fn=eval_elbo_fn,
        )
        print("With EMA, got ELBO %.2f." % out_ema["final_elbo"])
        print("With EMA, got ln Z %.2f." % out_ema["final_ln_Z"])
        results["final_elbo_ema"] = out_ema["final_elbo"]
        results["final_ln_Z_ema"] = out_ema["final_ln_Z"]

    # ---- W2 for tractable targets (reference main.py:249-272) ------------
    if target.sample is not None and config.model in ("nice", "funnel", "gmm"):
        n_tot = config.n_samples * config.n_input_dist_seeds
        target_samples = target.sample(jax.random.PRNGKey(1), n_tot)
        other = target.sample(jax.random.PRNGKey(2), n_tot)
        w2 = calculate_w2_distances(
            out["samples"],
            target_samples,
            other,
            config.n_samples,
            config.n_input_dist_seeds,
            min(config.n_sinkhorn, config.n_samples),
        )
        logger.log(w2)
        results.update(w2)
        # EMA-branch W2 too (reference main.py:263-272).
        if config.use_ema and result.ema_params is not None:
            w2_ema = calculate_w2_distances(
                out_ema["samples"],
                target_samples,
                other,
                config.n_samples,
                config.n_input_dist_seeds,
                min(config.n_sinkhorn, config.n_samples),
            )
            w2_ema = {k + "_ema": v for k, v in w2_ema.items()}
            logger.log(w2_ema)
            results.update(w2_ema)

    # ---- Final NICE image grid (reference main.py:274-282) ----------------
    if config.model == "nice" and config.plot_dir:
        from cmcd_tpu.utils import plotting

        os.makedirs(config.plot_dir, exist_ok=True)
        plotting.make_grid(
            jax.device_get(out["samples"]),
            config.im_size,
            n=64,
            path=os.path.join(config.plot_dir, "nice_final_grid.png"),
        )

    # ---- Artifact dump (reference main.py:286-301) ------------------------
    if config.checkpoint_dir:
        merged = {**params["train"], **params["notrain"]}
        path = os.path.join(
            config.checkpoint_dir,
            f"{config.model}_{config.boundmode}_{config.nbridges}_params.pkl",
        )
        with open(path, "wb") as f:
            pickle.dump(jax.device_get(merged), f)

    logger.close()
    return results


def main(argv=None):
    try:
        config = parse_flags(sys.argv[1:] if argv is None else argv)
    except ValueError as e:
        sys.exit(f"error: {e}")
    enable_compile_cache()
    run_experiment(config)


if __name__ == "__main__":
    main()
