"""Sample visualization (reference src/utils.py:18-83, 136-178).

File-based matplotlib output with optional wandb forwarding — the reference
hard-requires wandb for every plot. Same plot types: NICE image grids, GMM
scatter + log-density contours, generic 2-D marginals.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as onp


def _get_plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plotting (--config.plot_dir) needs matplotlib, which is not "
            "installed: install it or leave --config.plot_dir empty"
        ) from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def require_matplotlib():
    """Fail at start-up, not after training, when plots cannot be made."""
    _get_plt()


def make_grid(x, im_size: int, n: int = 16, path: Optional[str] = None, wandb_run=None,
              wandb_prefix: str = ""):
    """Grid of flattened images (reference src/utils.py:18-40)."""
    plt = _get_plt()
    x = onp.asarray(x[:n]).reshape(-1, im_size, im_size)
    n_rows = int(onp.sqrt(n))
    fig, ax = plt.subplots(n_rows, n_rows, figsize=(8, 8))
    for i in range(n_rows):
        for j in range(n_rows):
            ax[i, j].imshow(x[i * n_rows + j], cmap="gray")
            ax[i, j].axis("off")
    _emit(fig, path, wandb_run, wandb_prefix)


def plot_contours_2d(log_prob_fn, ax, bound: float = 3.0, levels: int = 20,
                     n_points: int = 200):
    """Contours of a batched 2-D log-density (reference src/utils.py:44-59)."""
    import itertools

    import jax.numpy as jnp

    xs = onp.linspace(-bound, bound, n_points)
    pts = onp.array(list(itertools.product(xs, xs)))
    lp = onp.asarray(log_prob_fn(jnp.asarray(pts)))
    lp = onp.clip(lp, -1000, None)
    ax.contour(
        pts[:, 0].reshape(n_points, n_points),
        pts[:, 1].reshape(n_points, n_points),
        lp.reshape(n_points, n_points),
        levels=levels,
    )


def plot_gmm(samples, log_prob_fn, loc_scaling: float, path: Optional[str] = None,
             wandb_run=None, wandb_prefix: str = ""):
    """Scatter + contours for 2-D mixture targets (reference src/utils.py:75-83)."""
    plt = _get_plt()
    bound = loc_scaling * 1.5
    fig, ax = plt.subplots(1, figsize=(5, 5))
    s = onp.clip(onp.asarray(samples), -bound, bound)
    ax.plot(s[:, 0], s[:, 1], "o", alpha=0.5)
    plot_contours_2d(log_prob_fn, ax, bound=bound, levels=50)
    ax.set_title("samples")
    fig.tight_layout()
    _emit(fig, path, wandb_run, wandb_prefix)


def plot_samples(model_name: str, log_prob_fn, samples, config, out_dir: str,
                 step: Optional[int] = None, wandb_run=None):
    """Per-step plot dispatch (reference src/utils.py:136-178)."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"_{step}" if step is not None else ""
    if model_name == "nice":
        make_grid(
            samples,
            getattr(config, "im_size", 14),
            n=64,
            path=os.path.join(out_dir, f"samples{tag}.png"),
            wandb_run=wandb_run,
        )
    elif model_name in ("many_gmm", "gmm"):
        plot_gmm(
            samples,
            log_prob_fn,
            getattr(config, "loc_scaling", 40.0) if model_name == "many_gmm" else 4.0,
            path=os.path.join(out_dir, f"samples{tag}.png"),
            wandb_run=wandb_run,
        )


def _emit(fig, path, wandb_run, wandb_prefix):
    if path:
        fig.savefig(path, dpi=100)
    if wandb_run is not None:
        try:
            import wandb

            wandb_run.log({wandb_prefix or "samples": wandb.Image(fig)})
        except ImportError:
            pass
    import matplotlib.pyplot as plt

    plt.close(fig)
