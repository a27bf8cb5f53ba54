"""Recipe regression: mechanical PASS/FAIL for every reference recipe.

Two layers:
- test_check_recipe_*: fast structural tests of the judgment logic, always
  run. They lock the contract that quality claims are machine-judged
  (check_recipe) rather than hand-written prose — the round-3 funnel_k8
  tolerance/result contradiction slipped through prose.
- test_run_all_recipes: executes EVERY entry full-scale via run_recipe and
  writes experiments/recipes_report.json. Marked `recipes` (excluded by
  default, see pytest.ini) — run on real hardware with
  `pytest -m recipes tests/test_recipes.py`.
"""

import pytest

from experiments.recipes import RECIPES, check_recipe


def test_check_recipe_judges_both_metrics():
    # funnel_k8 pins BOTH the published ELBO (the reference's K=8 number)
    # and a ln Z band; a result matching the recorded round-3 run
    # (ELBO -1.00, ln Z -0.374, RESULTS.md) must PASS as specified.
    rec = check_recipe(
        "funnel_k8", {"final_ln_Z": -0.374, "final_elbo": -1.00}
    )
    assert rec["pass"], rec
    assert {c["metric"] for c in rec["checks"]} == {"ln_Z", "ELBO"}
    # An ELBO far from the published value must FAIL even when ln Z is
    # inside its (bias-widened) band.
    rec = check_recipe(
        "funnel_k8", {"final_ln_Z": -0.374, "final_elbo": -1.5}
    )
    assert not rec["pass"], rec


def test_every_tolerance_admits_its_recorded_result():
    """Recorded full-scale results (RESULTS.md) must pass their own
    entries — the tolerance table and the claims can't contradict."""
    recorded = {
        # recipe: (final_ln_Z, final_elbo) from RESULTS.md full runs.
        "funnel_k8": (-0.374, -1.000),
        "many_gmm_vargrad": (-0.043, None),
        # 150k-iteration K=8 ladder cell (gmm_ladder_150k.json): the
        # tightened entry (ln Z tol 0.1, ELBO floor at the published
        # -0.536) admits it.
        "gmm_cais": (0.0093, -0.352),
    }
    for name, (lnz, elbo) in recorded.items():
        results = {"final_ln_Z": lnz, "final_elbo": elbo}
        rec = check_recipe(name, results)
        assert rec["pass"], (name, rec)


def test_check_recipe_lgcp_elbo_floor():
    # lgcp has no analytic ln Z, but the entry is NOT vacuous: a mechanical
    # ELBO floor (>= +400, the level every recorded run of this recipe
    # reaches) separates a working path from a silently broken one.
    rec = check_recipe("lgcp_k8", {"final_ln_Z": 500.0,
                                   "final_elbo": 430.0})
    assert rec["pass"] and rec["checks"], rec
    rec = check_recipe("lgcp_k8", {"final_ln_Z": 500.0,
                                   "final_elbo": -364.0})
    assert not rec["pass"], rec


def test_check_recipe_vacuous_spec_fails():
    # A spec yielding zero checks must FAIL loudly (round-4 verdict weak
    # #2: lgcp_k8 used to PASS with an empty checks array).
    from experiments import recipes

    recipes.RECIPES["_vacuous_probe"] = dict(flags={})
    try:
        rec = check_recipe("_vacuous_probe", {"final_ln_Z": 0.0,
                                              "final_elbo": 0.0})
        assert not rec["pass"] and rec.get("vacuous"), rec
    finally:
        del recipes.RECIPES["_vacuous_probe"]


def test_no_recipe_entry_is_vacuous():
    """Every shipped entry must anchor at least one mechanical check."""
    for name, spec in RECIPES.items():
        assert (spec.get("ln_z_true") is not None
                or spec.get("elbo_true") is not None
                or spec.get("elbo_floor") is not None), name


def test_run_all_merge_splices_subset(tmp_path, monkeypatch):
    """--only NAME re-runs one entry and splices it into the existing
    report (recomputing all_pass) without touching the other records —
    the cheap path when a single spec changes."""
    import json

    import cmcd_tpu.main
    from experiments.recipes import run_all

    out = tmp_path / "report.json"
    stale = {
        "entries": [
            {"recipe": "funnel_k8", "pass": True, "checks": [],
             "results": {"final_ln_Z": -0.374}},
            {"recipe": "gmm_ula", "pass": False,
             "checks": [{"metric": "ln_Z", "pass": False}],
             "results": {"final_ln_Z": -9.0}},
            {"recipe": "_removed_entry", "pass": True, "checks": []},
        ],
        "all_pass": False,
    }
    out.write_text(json.dumps(stale))
    monkeypatch.setattr(
        cmcd_tpu.main, "run_experiment",
        lambda config: {"final_ln_Z": 0.01, "final_elbo": -1.0},
    )
    rep = run_all(out_path=str(out), names=["gmm_ula"], merge=True)
    by_name = {r["recipe"]: r for r in rep["entries"]}
    # The re-run entry is fresh and passing; the untouched entry survives;
    # the entry no longer in RECIPES is dropped; all_pass is recomputed.
    assert by_name["gmm_ula"]["pass"], rep
    assert by_name["gmm_ula"]["results"]["final_ln_Z"] == 0.01
    assert by_name["funnel_k8"]["results"]["final_ln_Z"] == -0.374
    assert "_removed_entry" not in by_name
    assert rep["all_pass"] is True
    # Entries come out in RECIPES order regardless of the stale layout.
    names = [r["recipe"] for r in rep["entries"]]
    assert names == [n for n in RECIPES if n in by_name]
    # The file on disk matches what was returned.
    assert json.loads(out.read_text()) == rep


@pytest.mark.recipes
@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(RECIPES))
def test_run_recipe_full_scale(name, tmp_path):
    from experiments.recipes import run_recipe

    ok, results = run_recipe(name)
    assert ok, (name, results)
