"""Entry points: what they import, where they cache compiled code, and that
chip_smoke.py refuses to run without a GPU."""

import json
import os
import subprocess
import sys
import textwrap

import jax

from cmcd_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# chex (a guaranteed dependency of optax) imports absl.logging itself, so the
# guard loads jax, numpy, scipy, optax and chex first and then blocks absl
# with the rest: what is left to import is this package's own doing.
_GUARD = textwrap.dedent("""
    import sys
    import jax, numpy, scipy, optax, chex
    allowed = {k.split(".")[0] for k, v in sys.modules.items() if v is not None}
    for name in ("absl", "ml_collections", "orbax", "matplotlib", "wandb"):
        sys.modules[name] = None
    import cmcd_tpu, cmcd_tpu.main, cmcd_tpu.train
    import chip_smoke
    cmcd_tpu.main.main([
        "--config.model", "funnel", "--config.boundmode", "MCD_CAIS_sn",
        "--config.nbridges", "2", "--config.N", "16", "--config.iters", "2",
        "--noconfig.pretrain_mfvi", "--config.n_samples", "16",
        "--config.n_input_dist_seeds", "2",
    ])
    added = {k.split(".")[0] for k, v in sys.modules.items() if v is not None}
    added -= allowed | set(sys.stdlib_module_names) | {"cmcd_tpu", "chip_smoke"}
    print("ADDED", sorted(m for m in added if not m.startswith("_")))
""")


def _run(code, env_extra=None, cwd=REPO, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_main_path_runs_without_optional_packages(tmp_path):
    proc = _run(_GUARD, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Done training, got ln Z" in proc.stdout
    assert "ADDED []" in proc.stdout, proc.stdout[-2000:]


def test_compile_cache_follows_environment_variable(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no cache of its
    own; JAX reads the variable itself."""
    assert compile_cache.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None
    proc = _run(
        "import jax\n"
        "from cmcd_tpu.utils.compile_cache import enable_compile_cache\n"
        "print('SET', enable_compile_cache())\n"
        "print('DIR', jax.config.jax_compilation_cache_dir)\n",
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SET None" in proc.stdout
    assert f"DIR {tmp_path}" in proc.stdout


def test_compile_cache_defaults_to_fixed_checkout_path():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    paths = {compile_cache.compile_cache_dir(env) for _ in range(3)}
    assert paths == {os.path.join(REPO, ".jax_cache")}
    before = jax.config.jax_compilation_cache_dir
    old = os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    try:
        assert compile_cache.enable_compile_cache() == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        if old is not None:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = old
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok")
