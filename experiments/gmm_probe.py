"""3-mode gmm large-K root-cause probe (round-5 VERDICT item #1).

The 150k-iteration gmm ladder (experiments/data/gmm_ladder_150k.json)
BEATS the reference's published ELBO at K=8/16 and is within 0.1 nat at
K=32/64, but DEGRADES past K=64 (-0.147 -> -0.221 -> -0.296 at
K=64/128/256) where the reference's cell-18 curve keeps tightening
(-0.059 -> -0.029 -> -0.013). lnZ stays ~0.006 at every K, so the gap is
pure weight variance (ELBO = lnZ - KL(q||p-path)), not bias.

This probe trains the README "gmm replicate" recipe
(/root/reference/README.md:73: emb_dim 20, eps 0.01, lr 1e-3, train_vi,
no MFVI) at large K under one-lever-at-a-time variations and records,
per run:
  - final ELBO / lnZ (the quality row),
  - pooled log-weight variance and normalized ESS (where the nats go),
  - occupancy over the 6 symmetrized modes (does the sampler drop modes
    at large K, or just get noisier?).

Usage (run ALONE - one process per chip):
  python -m experiments.gmm_probe                  # default K x variants
  GP_KS=256 GP_ITERS=150000 python -m experiments.gmm_probe base train_eps
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as onp

# The 6 modes of the symmetrized 3-component mixture: the 3 component
# means (targets/gmm.py _MEANS = reference model_handler.py:169-172) and
# their coordinate flips.
_MODES = onp.array(
    [[3.0, 0.0], [-2.5, 0.0], [2.0, 3.0], [0.0, 3.0], [0.0, -2.5], [3.0, 2.0]]
)

# One lever per variant vs the README recipe the ladder used.
VARIANTS = {
    "base": {},
    "train_eps": {"train_eps": True},
    "cos_sq": {"eps_schedule": "cos_sq"},
    "eps_half": {"init_eps": 0.005},
    "eps_double": {"init_eps": 0.02},
    "lr_low": {"lr": 1e-4},
    "ema": {"use_ema": True},
    # Combined best levers from the one-at-a-time K=256 sweep (cos_sq
    # -0.157, eps_half -0.206 vs base -0.281): does the eps story compound?
    "cos_sq_eps_half": {"eps_schedule": "cos_sq", "init_eps": 0.005},
    # Per-K eps interpolation (FUNNEL_EPS_DICT pattern): the full tuned
    # ladder showed small K wants eps 0.01 and large K wants cos_sq+0.005,
    # with the crossover between K=16 and K=32 — probe the mid-K cells
    # with cos_sq at the base and an intermediate step.
    "cos_sq_eps_0075": {"eps_schedule": "cos_sq", "init_eps": 0.0075},
    # Other end of the interpolation: if optimal eps keeps shrinking with
    # K, the K=256 cell may want less than 0.005.
    "cos_sq_eps_quarter": {"eps_schedule": "cos_sq", "init_eps": 0.0025},
    "cos_sq_eps_8th": {"eps_schedule": "cos_sq", "init_eps": 0.00125},
    # Round-5 continuation: every halving at K=256 kept improving
    # (-0.094/-0.077/-0.055 at 0.005/0.0025/0.00125) — find the turn.
    "cos_sq_eps_16th": {"eps_schedule": "cos_sq", "init_eps": 0.000625},
}


def mode_occupancy(samples: onp.ndarray) -> list[float]:
    """Fraction of samples nearest each of the 6 symmetrized modes."""
    d = onp.linalg.norm(samples[:, None, :] - _MODES[None], axis=-1)
    idx = onp.argmin(d, axis=1)
    return [float(onp.mean(idx == k)) for k in range(len(_MODES))]


def weight_stats(neg_elbos: onp.ndarray) -> dict:
    """Pooled log-weight variance + normalized ESS from the (S, n)
    negative-ELBO eval matrix (logw = -neg_elbo; each group is an
    independent unbiased lnZ estimator, RESULTS.md 'Quality')."""
    logw = -onp.asarray(neg_elbos).reshape(-1)
    logw = logw[onp.isfinite(logw)]
    lse = onp.logaddexp.reduce(logw)
    p = onp.exp(logw - lse)
    ess = 1.0 / onp.sum(p * p)
    return {
        "logw_var": float(onp.var(logw)),
        "ess_frac": float(ess / logw.size),
        "n": int(logw.size),
    }


def run_probe(ks, variant_names, out_path="experiments/data/gmm_probe.json"):
    from experiments.baseline_grid import REFERENCE_ELBO, grid_config
    from cmcd_tpu.main import run_experiment

    rows = []
    for k in ks:
        for name in variant_names:
            config = grid_config("gmm", k)
            config.iters = int(os.environ.get("GP_ITERS", 150000))
            for kk, v in VARIANTS[name].items():
                setattr(config, kk, v)
            t0 = time.time()
            results = run_experiment(config)
            row = {
                "K": k,
                "variant": name,
                "elbo": float(results["final_elbo"]),
                "ln_Z": float(results["final_ln_Z"]),
                "elbo_ref": REFERENCE_ELBO["gmm"].get(k),
                "occupancy": mode_occupancy(results["samples"]),
                **weight_stats(results["neg_elbos"]),
                "wall_s": round(time.time() - t0, 1),
                "iters": config.iters,
            }
            if config.use_ema and "final_elbo_ema" in results:
                row["elbo_ema"] = float(results["final_elbo_ema"])
                row["ln_Z_ema"] = float(results["final_ln_Z_ema"])
            rows.append(row)
            occ = "/".join(f"{x:.2f}" for x in row["occupancy"])
            print(
                f"[probe] K={k} {name}: ELBO {row['elbo']:.3f} "
                f"(ref {row['elbo_ref']}) lnZ {row['ln_Z']:.3f} "
                f"logw_var {row['logw_var']:.3f} ess {row['ess_frac']:.3f} "
                f"occ {occ} [{row['wall_s']}s]"
            )
            # Checkpoint after EVERY run: a sweep killed midway must not
            # lose the finished rows (each run takes minutes).
            if out_path:
                _write_merged(out_path, rows)
    report = {"rows": rows, "env": {k: os.environ.get(k) for k in ("GP_ITERS", "GP_KS")}}
    if out_path:
        report["rows"] = _write_merged(out_path, rows)
        print(f"wrote {out_path}")
    return report


def _write_merged(out_path, rows):
    """Merge `rows` over any prior artifact (fresh rows win on the
    (K, variant, iters) key) and write atomically; returns the union."""
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    merged = list(rows)
    if os.path.exists(out_path):
        prior = json.load(open(out_path))["rows"]
        seen = {(r["K"], r["variant"], r["iters"]) for r in merged}
        merged[:0] = [
            r for r in prior
            if (r["K"], r["variant"], r["iters"]) not in seen
        ]
    report = {"rows": merged,
              "env": {k: os.environ.get(k) for k in ("GP_ITERS", "GP_KS")}}
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, out_path)
    return merged


if __name__ == "__main__":
    names = [a for a in sys.argv[1:] if not a.startswith("--")] or list(VARIANTS)
    ks = tuple(int(x) for x in os.environ.get("GP_KS", "128,256").split(","))
    run_probe(ks, names)
