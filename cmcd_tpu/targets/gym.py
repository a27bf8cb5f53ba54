"""Reimplementations of the inference_gym targets used by the reference:
banana, brownian, lorenz (src/model_handler.py:46-64).

The reference wraps inference_gym's VectorModel with the default event-space
bijector and its forward log-det (src/model_handler.py:47-54); here each
target is written directly in unconstrained space with the bijector folded
in analytically (Exp for positive scales contributes +u to the log-density).

Data provenance:
- banana needs no data (analytic, normalized; ln Z = 0 with the density
  written in full).
- brownian uses inference_gym's published observation vector (20 observed
  locations, middle 10 timesteps missing), reproduced as constants.
- lorenz (ConvectionLorenzBridge): inference_gym ships a specific observed
  trajectory that is not available offline; here the observations are
  generated from the model itself with a fixed PRNG seed. The posterior is
  structurally identical but numerically different from the reference's —
  documented deviation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as onp

from cmcd_tpu.distributions import LOG_2PI
from cmcd_tpu.targets.base import Target


def _norm_logpdf(x, loc, scale):
    return -0.5 * ((x - loc) / scale) ** 2 - 0.5 * LOG_2PI - jnp.log(scale)


# ---------------------------------------------------------------------------
# Banana (inference_gym Banana, ndims=2, curvature=0.03)
# ---------------------------------------------------------------------------


def make_banana(curvature: float = 0.03) -> Target:
    def log_prob(z):
        """z: (N, 2) -> (N,). x0 ~ N(0, 10); x1 | x0 ~ N(c (x0^2 - 100), 1)."""
        x0, x1 = z[:, 0], z[:, 1]
        return _norm_logpdf(x0, 0.0, 10.0) + _norm_logpdf(
            x1, curvature * (x0**2 - 100.0), 1.0
        )

    def sample(key, n):
        k0, k1 = jax.random.split(key)
        x0 = 10.0 * jax.random.normal(k0, (n,))
        x1 = curvature * (x0**2 - 100.0) + jax.random.normal(k1, (n,))
        return jnp.stack([x0, x1], axis=-1)

    return Target(
        name="banana",
        dim=2,
        log_prob=log_prob,
        sample=sample,
        # Recorded so tools can rebuild exactly this density.
        params={"curvature": curvature},
    )


# ---------------------------------------------------------------------------
# Brownian motion with unknown scales, middle observations missing
# (inference_gym BrownianMotionUnknownScalesMissingMiddleObservations)
# ---------------------------------------------------------------------------

# Observed locations from inference_gym (timesteps 0-9 and 20-29).
_BROWNIAN_OBS_FIRST = onp.array(
    [
        0.21592641,
        0.118771404,
        -0.07945447,
        0.037677474,
        -0.27885845,
        -0.1484156,
        -0.3250906,
        -0.22957903,
        -0.44110894,
        -0.09830782,
    ]
)
_BROWNIAN_OBS_LAST = onp.array(
    [
        -0.8786016,
        -0.83736074,
        -0.7384849,
        -0.8939254,
        -0.7774566,
        -0.70238715,
        -0.87771565,
        -0.51853573,
        -0.6948214,
        -0.6202789,
    ]
)


def make_brownian() -> Target:
    num_timesteps = 30
    dim = num_timesteps + 2

    def log_prob(z):
        """z: (N, 32) -> (N,). Layout [u_innovation, u_observation, x_0..x_29];
        scales enter as u = log(scale) with the Exp-bijector Jacobian folded
        in (LogNormal(0,2) prior on the scale == N(0,2) on u)."""
        u_inn, u_obs = z[:, 0], z[:, 1]
        x = z[:, 2:]
        inn_scale = jnp.exp(u_inn)[:, None]
        obs_scale = jnp.exp(u_obs)[:, None]

        lp = _norm_logpdf(u_inn, 0.0, 2.0) + _norm_logpdf(u_obs, 0.0, 2.0)
        # Brownian prior: x_0 ~ N(0, inn); x_t ~ N(x_{t-1}, inn).
        lp += jnp.sum(_norm_logpdf(x[:, :1], 0.0, inn_scale), axis=-1)
        lp += jnp.sum(_norm_logpdf(x[:, 1:], x[:, :-1], inn_scale), axis=-1)
        # Observations at t in [0, 10) and [20, 30).
        lp += jnp.sum(_norm_logpdf(_BROWNIAN_OBS_FIRST, x[:, :10], obs_scale), axis=-1)
        lp += jnp.sum(_norm_logpdf(_BROWNIAN_OBS_LAST, x[:, 20:], obs_scale), axis=-1)
        return lp

    return Target(name="brownian", dim=dim, log_prob=log_prob)


# ---------------------------------------------------------------------------
# Convection Lorenz bridge (inference_gym ConvectionLorenzBridge)
# ---------------------------------------------------------------------------


def _lorenz_drift(x):
    """Classic Lorenz-63 dynamics, batched over trailing shape (..., 3)."""
    a, b, c = x[..., 0], x[..., 1], x[..., 2]
    return jnp.stack(
        [10.0 * (b - a), a * (28.0 - c) - b, a * b - 8.0 / 3.0 * c], axis=-1
    )


def _simulate_lorenz_observations(key, num_timesteps, dt, innovation_scale, obs_scale):
    """Generate a fixed observed trajectory from the generative model."""
    k0, knoise, kobs = jax.random.split(key, 3)
    x = jax.random.normal(k0, (3,))

    def step(x, k):
        noise = innovation_scale * jnp.sqrt(dt) * jax.random.normal(k, (3,))
        x_next = x + dt * _lorenz_drift(x) + noise
        return x_next, x_next

    keys = jax.random.split(knoise, num_timesteps - 1)
    _, rest = jax.lax.scan(step, x, keys)
    traj = jnp.concatenate([x[None], rest], axis=0)  # (T, 3)
    obs = traj[:, 0] + obs_scale * jax.random.normal(kobs, (num_timesteps,))
    return obs


def make_lorenz() -> Target:
    num_timesteps = 30
    dt = 0.02
    innovation_scale = 0.1
    obs_scale = 1.0
    dim = 3 * num_timesteps

    obs = _simulate_lorenz_observations(
        jax.random.PRNGKey(42), num_timesteps, dt, innovation_scale, obs_scale
    )
    # Convection bridge: observe the first component for the first and last
    # 10 timesteps only.
    obs_first, obs_last = obs[:10], obs[20:]

    def log_prob(z):
        """z: (N, 90) -> (N,). Latents are the full (T, 3) trajectory."""
        x = z.reshape(z.shape[0], num_timesteps, 3)
        step_scale = innovation_scale * jnp.sqrt(dt)

        lp = jnp.sum(_norm_logpdf(x[:, 0], 0.0, 1.0), axis=-1)
        pred = x[:, :-1] + dt * _lorenz_drift(x[:, :-1])
        lp += jnp.sum(_norm_logpdf(x[:, 1:], pred, step_scale), axis=(-1, -2))
        lp += jnp.sum(_norm_logpdf(obs_first, x[:, :10, 0], obs_scale), axis=-1)
        lp += jnp.sum(_norm_logpdf(obs_last, x[:, 20:, 0], obs_scale), axis=-1)
        return lp

    return Target(
        name="lorenz",
        dim=dim,
        log_prob=log_prob,
        # The concrete observation vectors (self-generated, see module
        # docstring) are recorded so tools (experiments/lorenz_anchor.py)
        # work on exactly this density.
        params={
            "num_timesteps": num_timesteps,
            "dt": dt,
            "innovation_scale": innovation_scale,
            "obs_scale": obs_scale,
            "obs_first": obs_first,
            "obs_last": obs_last,
        },
    )
