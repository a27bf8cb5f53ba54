"""NICE normalizing-flow target.

Reference: src/nice.py (haiku) + loader src/model_handler.py:89-121 which
pulls pretrained params from a wandb artifact. Here the flow is pure JAX
(params pytree) and params load from a local checkpoint written by
cmcd_tpu.targets.nice_train.

Architecture parity (src/nice.py:15-118): 4 additive coupling steps, each
with a 5-layer ReLU MLP (hidden 1000) mapping the first half to a shift for
the second half, a full-reversal permutation before every step, and a
trainable per-dim logscale on the latent.

Because NICE is a bijective flow with an exactly tracked Jacobian, its
density is normalized for *any* parameter values: ln Z = 0 holds at random
init too. When no checkpoint exists, make_nice falls back to a fixed-seed
random init (documented capability gap: the original is trained on MNIST,
which is not available in this offline environment).
"""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp

from cmcd_tpu.distributions import LOG_2PI
from cmcd_tpu.targets.base import Target

_DEFAULT_CKPT = os.path.join(os.path.dirname(__file__), "data", "nice_params.pkl")


def _mlp_init(key, in_dim, hidden, out_dim, depth=5):
    dims = [in_dim] + [hidden] * (depth - 1) + [out_dim]
    layers = []
    for i in range(depth):
        key, wkey = jax.random.split(key)
        stddev = 1.0 / jnp.sqrt(jnp.asarray(dims[i], jnp.float32))
        w = jax.random.truncated_normal(wkey, -2.0, 2.0, (dims[i], dims[i + 1])) * stddev
        layers.append({"w": w, "b": jnp.zeros(dims[i + 1])})
    return layers


def _mlp_apply(layers, x):
    for layer in layers[:-1]:
        x = jax.nn.relu(x @ layer["w"] + layer["b"])
    last = layers[-1]
    return x @ last["w"] + last["b"]


def nice_init(key, dim: int, n_steps: int = 4, h_depth: int = 5, h_dim: int = 1000):
    half = dim // 2
    split = half + (dim % 2)
    nets = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        nets.append(_mlp_init(sub, split, h_dim, dim - split, depth=h_depth))
    return {"nets": nets, "logscale": jnp.zeros(dim)}


def nice_forward(params, x):
    """x -> z, batched (N, dim). Reversal permutation before each step."""
    dim = x.shape[-1]
    split = dim // 2 + (dim % 2)
    for net in params["nets"]:
        x = x[:, ::-1]
        xa, xb = x[:, :split], x[:, split:]
        x = jnp.concatenate([xa, xb + _mlp_apply(net, xa)], axis=-1)
    return x


def nice_reverse(params, y):
    """z -> x, batched (N, dim)."""
    dim = y.shape[-1]
    split = dim // 2 + (dim % 2)
    for net in reversed(params["nets"]):
        ya, yb = y[:, :split], y[:, split:]
        x = jnp.concatenate([ya, yb - _mlp_apply(net, ya)], axis=-1)
        y = x[:, ::-1]
    return y


def nice_log_prob(params, x):
    """log p(x), batched (N, dim) -> (N,) (src/nice.py:87-97)."""
    z = nice_forward(params, x)
    zs = z * jnp.exp(params["logscale"])
    logp = -0.5 * jnp.sum(zs * zs + LOG_2PI, axis=-1)
    return logp + jnp.sum(params["logscale"])


def nice_sample(params, key, n: int):
    dim = params["logscale"].shape[0]
    zs = jax.random.normal(key, (n, dim))
    return nice_reverse(params, zs / jnp.exp(params["logscale"]))


def save_nice_params(params, path: str = _DEFAULT_CKPT):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(jax.device_get(params), f)


def load_nice_params(path: str = _DEFAULT_CKPT):
    with open(path, "rb") as f:
        raw = pickle.load(f)
    return jax.tree_util.tree_map(jnp.asarray, raw)


def make_nice(
    im_size: int = 14, hidden_dim: int = 1000, checkpoint_path: str | None = None
) -> Target:
    dim = im_size * im_size
    path = checkpoint_path or _DEFAULT_CKPT
    if os.path.exists(path):
        params = load_nice_params(path)
    else:
        # Untrained flow: still a valid normalized density (ln Z = 0).
        params = nice_init(jax.random.PRNGKey(0), dim, h_dim=hidden_dim)

    def log_prob(x):
        return nice_log_prob(params, x)

    def sample(key, n):
        return nice_sample(params, key, n)

    return Target(
        name="nice",
        dim=dim,
        log_prob=log_prob,
        sample=sample,
        # The concrete flow parameters are recorded so tools can rebuild
        # exactly this density.
        params={"flow_params": params, "im_size": im_size},
    )
