"""ELBO-vs-K grid runner (BASELINE.md cell-18 curve-shape parity).

The reference's quality baseline is a 9-target x K in {8,16,32,64,128,256}
ELBO table hardcoded in /root/reference/src/notebooks/plotting_rebuttal.ipynb
(code cell 18; transcribed in BASELINE.md). This runner executes the sweep
on THIS framework's training path and emits one artifact
(experiments/data/baseline_grid.json + a markdown table) with the reference
row alongside each measured row, so curve SHAPE (monotone improvement in K,
same ballpark) can be checked mechanically rather than from scattered
endpoint runs.

Budget knobs (the full reference runs are 150k iters each; the curve shape
emerges far earlier):
  BG_ITERS       training iterations per cell   (default 3000)
  BG_MFVI_ITERS  MFVI pretrain iterations       (default 10000)
  BG_KS          comma-separated K list         (default 8,16,32,64,128,256)
  BG_SEEDS       eval seed-batches (n_input_dist_seeds, default 10)
  BG_OUT         artifact path (default experiments/data/baseline_grid.json)

Usage (run ALONE - one process per chip):
  python -m experiments.baseline_grid funnel gmm log_sonar seeds
  python -m experiments.baseline_grid --all
"""

from __future__ import annotations

import json
import os
import sys
import time

# Reference ELBO table: plotting_rebuttal.ipynb cell 18 via BASELINE.md.
REFERENCE_ELBO = {
    "gmm": {8: -0.536, 16: -0.255, 32: -0.119, 64: -0.059, 128: -0.029,
            256: -0.013},
    "lgcp": {8: -364.074, 16: -135.207, 32: 86.106, 64: 269.566,
             128: 390.33, 256: 453.395},
    "banana": {8: -1.767, 16: -1.256, 32: -0.752, 64: -0.690, 128: -0.437,
               256: -0.284},
    "brownian": {8: -63.32, 16: -28.714, 32: -12.23, 64: -4.76, 128: -1.675,
                 256: -0.131},
    "log_sonar": {8: -178.589, 16: -137.691, 32: -120.557, 64: -113.835,
                  128: -110.901, 256: -109.562},
    "log_ionosphere": {8: -204.594, 16: -149.107, 32: -127.964, 64: -118.812,
                       128: -114.827, 256: -113.123},
    "seeds": {8: -108.676, 16: -88.068, 32: -79.89, 64: -76.275,
              128: -74.774, 256: -74.049},
    "funnel": {8: -1.013, 16: -0.65, 32: -0.408, 64: -0.359, 128: -0.255,
               256: -0.211},
}

# Per-target base flags. funnel/gmm mirror the validated recipe entries
# (experiments/recipes.py funnel_k8 / gmm_cais); posterior targets use the
# reference's MFVI-initialized protocol with LR_DICT lrs applied by
# apply_lookup_tables (config.py:184-201 = reference src/utils.py:181-204).
_POSTERIOR = dict(
    boundmode="MCD_CAIS_sn", N=300, emb_dim=20, init_eps=0.01,
    pretrain_mfvi=True, train_vi=True, train_eps=True, grad_clipping=True,
)
TARGET_FLAGS = {
    "funnel": dict(
        boundmode="MCD_CAIS_sn", N=300, emb_dim=48, init_sigma=1,
        pretrain_mfvi=False, train_vi=True, train_eps=False,
        eps_schedule="cos_sq",  # eps/lr come from FUNNEL_EPS_DICT
    ),
    "gmm": dict(
        boundmode="MCD_CAIS_sn", N=300, emb_dim=20, init_eps=0.01,
        init_sigma=1, pretrain_mfvi=False, train_vi=True, train_eps=False,
        lr=1e-3,
    ),
    "banana": dict(
        boundmode="MCD_CAIS_sn", N=300, emb_dim=20, init_eps=0.01,
        init_sigma=1, pretrain_mfvi=False, train_vi=True, train_eps=False,
        lr=1e-3,
    ),
    "log_sonar": dict(_POSTERIOR),
    "log_ionosphere": dict(_POSTERIOR),
    "seeds": dict(_POSTERIOR),
    "brownian": dict(_POSTERIOR),
    "lgcp": dict(_POSTERIOR, N=20, lr=1e-4, n_samples=100),
    # lorenz: observations are self-generated (inference_gym absent offline
    # — see targets/gym.py), so ELBO LEVELS are not comparable to the
    # reference cell-18 lorenz row (87502..-3745, its own data); the grid
    # checks curve SHAPE (monotone in K) only. LR comes from LR_DICT
    # (MCD_CAIS_sn: 1e-5). init_eps matches the recorded working lorenz
    # protocol (experiments/posterior_moments.py --eps default; the 90-D
    # bridge diverges at the generic posterior 0.01, RESULTS.md round 2).
    "lorenz": dict(_POSTERIOR, init_eps=1e-5),
}

# Absolute monotone slack overrides (nats) for targets whose ELBO scale
# makes the default 0.15-nat slack meaningless; lorenz ELBOs sit near -176
# (RESULTS.md) with multi-nat eval noise between adjacent K.
MONOTONE_TOL = {"lorenz": 5.0}

KS_DEFAULT = (8, 16, 32, 64, 128, 256)


def grid_config(target: str, k: int):
    """One cell's config (pure; used by the structural test)."""
    from cmcd_tpu.config import get_config

    config = get_config()
    config.model = target
    for kk, v in TARGET_FLAGS[target].items():
        setattr(config, kk, v)
    config.nbridges = k
    config.iters = int(os.environ.get("BG_ITERS", 3000))
    config.mfvi_iters = int(os.environ.get("BG_MFVI_ITERS", 10000))
    config.n_input_dist_seeds = int(os.environ.get("BG_SEEDS", 10))
    return config


def run_grid(targets, ks=KS_DEFAULT,
             out_path="experiments/data/baseline_grid.json") -> dict:
    from cmcd_tpu.main import run_experiment

    rows = []
    for target in targets:
        for k in ks:
            config = grid_config(target, k)
            t0 = time.time()
            results = run_experiment(config)
            cell = {
                "target": target, "K": k,
                "elbo": float(results["final_elbo"]),
                "ln_Z": float(results["final_ln_Z"]),
                "elbo_ref": REFERENCE_ELBO.get(target, {}).get(k),
                "wall_s": round(time.time() - t0, 1),
                "iters": config.iters,
            }
            rows.append(cell)
            print(f"[grid] {target} K={k}: ELBO {cell['elbo']:.3f} "
                  f"(ref {cell['elbo_ref']}) lnZ {cell['ln_Z']:.3f} "
                  f"[{cell['wall_s']}s]")
    if out_path and os.path.exists(out_path):
        # Merge with prior cells (idempotent partial re-runs: fresh rows
        # replace same-(target, K) cells, other targets' rows are kept, and
        # the monotone verdicts are recomputed over the union).
        prior = json.load(open(out_path))["rows"]
        seen = {(r["target"], r["K"]) for r in rows}
        rows[:0] = [r for r in prior if (r["target"], r["K"]) not in seen]
    report = {
        "rows": rows,
        "monotone": check_monotone(rows),
        "env": {k: os.environ.get(k) for k in
                ("BG_ITERS", "BG_MFVI_ITERS", "BG_KS", "BG_SEEDS")},
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {out_path}")
    print(markdown_table(rows))
    return report


def check_monotone(rows, slack=0.15) -> dict:
    """Curve-shape check: for each target, ELBO should improve (increase)
    with K the way the reference's does. `slack` tolerates eval noise in
    nats scaled by the local step size of the reference curve."""
    by_target = {}
    for r in rows:
        by_target.setdefault(r["target"], []).append(r)
    verdicts = {}
    for t, cells in by_target.items():
        cells = sorted(cells, key=lambda c: c["K"])
        ok = True
        for a, b in zip(cells, cells[1:]):
            ref_step = None
            if a["elbo_ref"] is not None and b["elbo_ref"] is not None:
                ref_step = abs(b["elbo_ref"] - a["elbo_ref"])
            tol = MONOTONE_TOL.get(t, slack * max(1.0, ref_step or 1.0))
            if b["elbo"] < a["elbo"] - tol:
                ok = False
        verdicts[t] = ok
    return verdicts


def markdown_table(rows) -> str:
    ks = sorted({r["K"] for r in rows})
    by_target = {}
    for r in rows:
        by_target.setdefault(r["target"], {})[r["K"]] = r
    lines = ["| target | " + " | ".join(f"K={k}" for k in ks) + " |",
             "|---|" + "---|" * len(ks)]
    for t, cells in by_target.items():
        meas = " | ".join(
            f"{cells[k]['elbo']:.3f}" if k in cells else "-" for k in ks)
        lines.append(f"| {t} (measured) | {meas} |")
        ref = " | ".join(
            str(REFERENCE_ELBO.get(t, {}).get(k, "-")) for k in ks)
        lines.append(f"| {t} (reference) | {ref} |")
    return "\n".join(lines)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    targets = list(TARGET_FLAGS) if "--all" in sys.argv else (
        args or ["funnel", "gmm", "log_sonar", "seeds"])
    ks = tuple(int(x) for x in
               os.environ.get("BG_KS", "8,16,32,64,128,256").split(","))
    out = os.environ.get("BG_OUT", "experiments/data/baseline_grid.json")
    rep = run_grid(targets, ks, out_path=out)
    print("monotone:", rep["monotone"])
