"""Reference-recipe parity harness (SURVEY.md §7.8).

Each entry maps a recipe from the reference README (/root/reference/README.md)
onto this framework's flag surface, with the analytic or published number to
check against. run_recipe() executes one and asserts the ln Z tolerance.

Usage:
  python -m experiments.recipes funnel_k8          # run one recipe
  python -m experiments.recipes --all [out.json]   # run every entry,
                                                   # write PASS/FAIL table
  python -m experiments.recipes --list
"""

from __future__ import annotations

import json
import os
import sys

RECIPES = {
    # README.md funnel replicate at K=8. The PUBLISHED reference number at
    # this K is the ELBO: -1.013 (plotting_rebuttal.ipynb cell 18 via
    # BASELINE.md) — we check that directly. ln Z at K=8 carries an
    # inherent ~-0.4 nat bias for an 8-bridge annealed sampler on the
    # funnel (every recorded run of THIS recipe lands at ln Z -0.37..-0.40
    # while its ELBO matches the reference's within 0.015 nat, RESULTS.md;
    # the 0.1-nat north star is stated for converged bridges and is met at
    # K>=128: ln Z -0.072 at K=128, -0.03 at K=256). Tolerance 0.5 reflects
    # the sampler's K=8 bias, not implementation slack — the tight check
    # here is the ELBO.
    "funnel_k8": dict(
        flags={
            "model": "funnel",
            "boundmode": "MCD_CAIS_sn",
            "N": 300,
            "emb_dim": 48,
            "init_eps": 0.1,
            "init_sigma": 1,
            "iters": 11000,
            "pretrain_mfvi": False,
            "train_vi": True,
            "train_eps": False,
            "lr": 0.01,
            "n_samples": 2000,
            "eps_schedule": "cos_sq",
        },
        ln_z_true=0.0,
        ln_z_tol=0.5,
        elbo_true=-1.013,
        elbo_tol=0.2,
    ),
    # README.md 40-GMM VarGrad recipe (the 5x wall-clock target config,
    # shortened iterations are NOT part of this entry — full recipe,
    # including the published --config.emb_dim 130 network width).
    "many_gmm_vargrad": dict(
        flags={
            "model": "many_gmm",
            "boundmode": "MCD_CAIS_var_sn",
            "N": 2000,
            "nbridges": 256,
            "emb_dim": 130,
            "init_eps": 0.65,
            "init_sigma": 15,
            "iters": 40000,
            "pretrain_mfvi": False,
            "train_eps": False,
            "train_vi": False,
            "grad_clipping": True,
            "lr": 0.005,
        },
        ln_z_true=0.0,
        ln_z_tol=0.25,
    ),
    # README.md LGCP: MFVI 20k (sufficient per the reference README) then
    # trained eps. Published ELBO at K=8 in BASELINE.md cell 18: -364.07;
    # ln Z has no analytic anchor (unnormalized posterior), so this recipe
    # checks ELBO progression rather than ln Z.
    "lgcp_k8": dict(
        flags={
            "model": "lgcp",
            "boundmode": "MCD_CAIS_sn",
            "N": 20,
            "nbridges": 8,
            "emb_dim": 20,
            "iters": 37500,
            "mfvi_iters": 20000,
            "pretrain_mfvi": True,
            "lr": 1e-4,
            "n_samples": 500,
        },
        ln_z_true=None,
        ln_z_tol=None,
        # No analytic ln Z (unnormalized posterior) — the mechanical check
        # is an ELBO floor. Published K=8 reference cell is -364.07
        # (plotting_rebuttal.ipynb cell 18 via BASELINE.md); every recorded
        # run of THIS recipe (MFVI 20k + trained eps) lands at ELBO >= +400
        # (RESULTS.md lgcp rows), so the floor is set there: a silently
        # broken LGCP path cannot PASS.
        elbo_floor=400.0,
    ),
    # README.md 40-GMM KL recipe with the PIS ("dds") net — the reference's
    # own published flag set (KL loss, full BPTT through the scan).
    "many_gmm_kl_dds": dict(
        flags={
            "model": "many_gmm",
            "boundmode": "MCD_CAIS_sn",
            "N": 2000,
            "nbridges": 256,
            "pretrain_mfvi": False,
            "init_sigma": 60,
            "grad_clipping": True,
            "init_eps": 1.0,
            "eps_schedule": "cos_sq",
            "lr": 0.001,
            "train_eps": False,
            "train_vi": False,
            "nn_arch": "dds",
            "iters": 5000,
        },
        ln_z_true=0.0,
        ln_z_tol=0.25,
    ),
    # README.md:34 40-GMM KL recipe, geffner net at the published width
    # ("kl 40gmm": emb_dim 130, eps 0.1, lr 0.005). iters: the reference
    # default is 150k (src/configs/base.py:109); 5000 under-trains this
    # 40-mode KL objective past the 0.25-nat check (round-4 regression run:
    # ln Z -0.343 +- 0.60 at 5k) — budgeted at 40k like the VarGrad
    # flagship entry.
    "many_gmm_kl": dict(
        flags={
            "model": "many_gmm",
            "boundmode": "MCD_CAIS_sn",
            "N": 2000,
            "nbridges": 256,
            "emb_dim": 130,
            "pretrain_mfvi": False,
            "init_sigma": 15,
            "grad_clipping": True,
            "init_eps": 0.1,
            "lr": 0.005,
            "train_eps": False,
            "train_vi": False,
            "iters": 40000,
        },
        ln_z_true=0.0,
        ln_z_tol=0.25,
    ),
    # Same 40-GMM KL recipe on the PISGRADNet ("dds_grad") arch — the
    # reference ships this net broken (src/nn_dds.py:195-317 crashes on its
    # trainable-string bug); it works here (zero-init grad gate), so this
    # entry is the E2E quality row the grad-equivalence tests don't give.
    # iters: like the geffner many_gmm_kl entry, 5k under-trains the
    # 40-mode KL objective (recorded round-5 run: ln Z -0.50 at 5k); the
    # zero-init grad gate means the net starts as pure PISNet and needs
    # the same 40k budget to learn the score-feature mixing.
    "many_gmm_kl_dds_grad": dict(
        flags={
            "model": "many_gmm",
            "boundmode": "MCD_CAIS_sn",
            "N": 2000,
            "nbridges": 256,
            "pretrain_mfvi": False,
            "init_sigma": 60,
            "grad_clipping": True,
            "init_eps": 1.0,
            "eps_schedule": "cos_sq",
            "lr": 0.001,
            "train_eps": False,
            "train_vi": False,
            "nn_arch": "dds_grad",
            "iters": 40000,
        },
        ln_z_true=0.0,
        ln_z_tol=0.25,
    ),
    # README.md:73 3-mode GMM replicate ("gmm replicate": emb_dim 20,
    # eps 0.01, lr 1e-3) at the reference's FULL budget (150k iterations,
    # src/configs/base.py:109 default — the round-4 11k-iter entry
    # under-trained the late-converging symmetrized target). The 150k
    # K=8 ladder cell (experiments/data/gmm_ladder_150k.json) records
    # ELBO -0.352 / ln Z +0.009, BEATING the published reference cell
    # (-0.536, plotting_rebuttal.ipynb cell 18 via BASELINE.md) — so the
    # checks are tightened to ln Z within 0.1 nat AND ELBO at least as
    # good as the published number.
    "gmm_cais": dict(
        flags={
            "model": "gmm",
            "boundmode": "MCD_CAIS_sn",
            "N": 300,
            "emb_dim": 20,
            "init_eps": 0.01,
            "init_sigma": 1,
            "iters": 150000,
            "pretrain_mfvi": False,
            "train_vi": True,
            "train_eps": False,
            "lr": 0.001,
            "n_samples": 500,
        },
        ln_z_true=0.0,
        ln_z_tol=0.1,
        elbo_floor=-0.536,
    ),
    # TUNED 3-mode gmm at the reference's worst-trailing cell (K=256):
    # the README recipe + the reference's own cosine-squared eps schedule
    # + the per-K interpolated init_eps the round-5 probe
    # (experiments/data/gmm_probe.json) measured best at full budget. The
    # eps axis at K=256 is BRACKETED: 0.0025/-0.077, 0.00125/-0.055,
    # 0.000625/-0.069 — the optimum is eps/8 of the README value, giving
    # ELBO -0.055 / ln Z +0.001 / pooled log-weight variance 0.129 /
    # ESS 0.90 (published cell -0.013). This is the
    # framework-recommended large-K gmm recipe; the probe's recorded runs
    # are the floor's provenance.
    "gmm_cais_tuned": dict(
        flags={
            "model": "gmm",
            "boundmode": "MCD_CAIS_sn",
            "N": 300,
            "nbridges": 256,
            "emb_dim": 20,
            "init_eps": 0.00125,
            "eps_schedule": "cos_sq",
            "init_sigma": 1,
            "iters": 150000,
            "pretrain_mfvi": False,
            "train_vi": True,
            "train_eps": False,
            "lr": 0.001,
            "n_samples": 500,
        },
        ln_z_true=0.0,
        ln_z_tol=0.1,
        elbo_floor=-0.12,
    ),
    # 2-mode GMM with plain ULA (driver config #1), CPU-runnable.
    "gmm_ula": dict(
        flags={
            "model": "gmm",
            "boundmode": "MCD_ULA",
            "N": 300,
            "nbridges": 8,
            "init_eps": 0.05,
            "init_sigma": 3,
            "iters": 5000,
            "pretrain_mfvi": False,
            "lr": 0.01,
        },
        ln_z_true=0.0,
        ln_z_tol=0.3,
    ),
}


def check_recipe(name: str, results: dict) -> dict:
    """Mechanical PASS/FAIL judgment of one recipe's results against its
    spec (ln Z and, where the reference publishes one, ELBO). Returns a
    JSON-ready record; quality claims should quote this, not prose."""
    spec = RECIPES[name]
    checks = []
    if spec.get("ln_z_true") is not None:
        err = abs(results["final_ln_Z"] - spec["ln_z_true"])
        checks.append({
            "metric": "ln_Z", "value": float(results["final_ln_Z"]),
            "true": spec["ln_z_true"], "err": round(float(err), 4),
            "tol": spec["ln_z_tol"], "pass": bool(err <= spec["ln_z_tol"]),
        })
    if spec.get("elbo_true") is not None:
        err = abs(results["final_elbo"] - spec["elbo_true"])
        checks.append({
            "metric": "ELBO", "value": float(results["final_elbo"]),
            "true": spec["elbo_true"], "err": round(float(err), 4),
            "tol": spec["elbo_tol"], "pass": bool(err <= spec["elbo_tol"]),
        })
    if spec.get("elbo_floor") is not None:
        val = float(results["final_elbo"])
        checks.append({
            "metric": "ELBO_floor", "value": val,
            "floor": spec["elbo_floor"],
            "pass": bool(val >= spec["elbo_floor"]),
        })
    # A spec that yields zero checks cannot PASS — a vacuous entry would
    # let a silently broken path count toward "N/N PASS" (round-4 verdict
    # weak #2). Every recipe must anchor at least one mechanical check.
    if not checks:
        return {"recipe": name, "pass": False, "vacuous": True, "checks": []}
    ok = all(c["pass"] for c in checks)
    return {"recipe": name, "pass": ok, "checks": checks}


def run_recipe(name: str):
    from cmcd_tpu.config import get_config
    from cmcd_tpu.main import run_experiment

    spec = RECIPES[name]
    config = get_config()
    for k, v in spec["flags"].items():
        setattr(config, k, v)
    results = run_experiment(config)
    print(f"[{name}] results:",
          {k: v for k, v in results.items() if isinstance(v, float)})
    record = check_recipe(name, results)
    for c in record["checks"]:
        if "floor" in c:
            print(f"[{name}] {c['metric']} = {c['value']:.3f} "
                  f"(floor {c['floor']}) -> "
                  f"{'PASS' if c['pass'] else 'FAIL'}")
        else:
            print(f"[{name}] |{c['metric']} - {c['true']}| = {c['err']:.3f} "
                  f"(tol {c['tol']}) -> {'PASS' if c['pass'] else 'FAIL'}")
    if record.get("vacuous"):
        print(f"[{name}] VACUOUS: spec has no checks -> FAIL")
    return record["pass"], results


def run_all(out_path: str = "experiments/recipes_report.json",
            names=None, merge=False) -> dict:
    """Execute every RECIPES entry via run_recipe and write one PASS/FAIL
    JSON table (the artifact RESULTS.md quality claims quote). Intended for
    real hardware (the flagship entries are full-scale recipes); the pytest
    hook is tests/test_recipes.py, marked `recipes` and excluded by
    default.

    merge=True (CLI: --only NAME ...) re-runs only `names` and splices the
    fresh records into the existing report by recipe name, recomputing
    all_pass — the cheap path when one entry's spec changed (same pattern
    as the grid runner's partial re-run merge). Entries no longer in
    RECIPES are dropped from the merged report."""
    from cmcd_tpu.config import get_config
    from cmcd_tpu.main import run_experiment

    prior = {}
    if merge and out_path and os.path.exists(out_path):
        with open(out_path) as f:
            for rec in json.load(f)["entries"]:
                if rec["recipe"] in RECIPES:
                    prior[rec["recipe"]] = rec

    report = {"entries": [], "all_pass": True}
    for name in (names or RECIPES):
        spec = RECIPES[name]
        config = get_config()
        for k, v in spec["flags"].items():
            setattr(config, k, v)
        results = run_experiment(config)
        record = check_recipe(name, results)
        record["results"] = {
            k: float(v) for k, v in results.items()
            if isinstance(v, (int, float))
        }
        prior[name] = record
        print(f"[{name}] -> {'PASS' if record['pass'] else 'FAIL'}")
    # Emit in RECIPES order so merged and full runs produce the same layout.
    report["entries"] = [prior[n] for n in RECIPES if n in prior]
    report["all_pass"] = all(r["pass"] for r in report["entries"])
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {out_path}")
    return report


if __name__ == "__main__":
    if "--list" in sys.argv or len(sys.argv) < 2:
        for k in RECIPES:
            print(k)
        sys.exit(0)
    if "--all" in sys.argv:
        args = [a for a in sys.argv[1:] if not a.startswith("--")]
        rep = run_all(out_path=args[0] if args
                      else "experiments/recipes_report.json")
        sys.exit(0 if rep["all_pass"] else 1)
    if "--only" in sys.argv:
        names = [a for a in sys.argv[1:] if not a.startswith("--")]
        assert names and all(n in RECIPES for n in names), names
        rep = run_all(names=names, merge=True)
        sys.exit(0 if rep["all_pass"] else 1)
    ok, _ = run_recipe(sys.argv[1])
    sys.exit(0 if ok else 1)
