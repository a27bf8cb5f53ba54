"""Geffner-style score network with a learned per-bridge embedding table.

Reference: src/nn.py:42-72. Two residual softplus blocks
(x + Softplus(Dense(in_dim)(x))), a final Dense(x_dim) head, a learned
embedding table emb[nbridges, emb_dim], and a trainable output scale
factor_sn initialized to 0 so the network starts as an exact identity-ULA
correction (output == 0 at init).

The reference builds the net with jax.example_libraries.stax and applies it
per chain under vmap; here the apply is natively batched. The bridge-index
lookup for the backward kernel at i+1 relies, in the reference, on XLA's
silent gather clamping at i = nbridges-1 (src/nn.py:68 with src/mcd_cais.py:78);
we make that clamp explicit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _dense_init(key, in_dim, out_dim):
    """Match stax.Dense defaults: glorot_normal weights, normal(1e-2) bias."""
    wkey, bkey = jax.random.split(key)
    w = jax.nn.initializers.glorot_normal()(wkey, (in_dim, out_dim))
    b = jax.nn.initializers.normal(1e-2)(bkey, (out_dim,))
    return {"w": w, "b": b}


def _dense_apply(p, x):
    return x @ p["w"] + p["b"]


def build_geffner_network(x_dim, emb_dim, nbridges, rho_dim=0, nlayers=2):
    """Returns (init_fn, apply_fn).

    Note: the reference hardcodes 2 residual blocks regardless of the nlayers
    config (src/nn.py:45-53 vs src/configs/base.py:87-88); pass nlayers=2 for
    reference parity. Other values use the generalized (unused in reference)
    form of src/nn_dds.py:22-52.
    """
    in_dim = x_dim + rho_dim + emb_dim

    def init_fn(key):
        keys = jax.random.split(key, nlayers + 2)
        layers = [_dense_init(keys[k], in_dim, in_dim) for k in range(nlayers)]
        head = _dense_init(keys[nlayers], in_dim, x_dim)
        emb = jax.random.normal(keys[nlayers + 1], (nbridges, emb_dim)) * 0.05
        return {
            "layers": layers,
            "head": head,
            "emb": emb,
            "factor_sn": jnp.zeros(()),
        }

    def _body(params, h):
        for layer in params["layers"]:
            h = h + jax.nn.softplus(_dense_apply(layer, h))
        out = _dense_apply(params["head"], h)
        return out * params["factor_sn"]

    def apply_fn(params, x, i):
        """x: (N, x_dim + rho_dim), i: int scalar -> (N, x_dim)."""
        i = jnp.clip(i, 0, nbridges - 1)
        emb = params["emb"][i]  # (emb_dim,)
        n = x.shape[0]
        h = jnp.concatenate([x, jnp.broadcast_to(emb, (n, emb.shape[0]))], axis=-1)
        return _body(params, h)

    def apply_blocks_fn(params, x, steps):
        """Per-step blocks: x (S, N, x_dim + rho_dim), steps (S,) int ->
        (S, N, x_dim).

        All S*N applications run as ONE dense (S*N, in) @ (in, in) matmul
        per layer (a vmap over steps emits S tiny batched matmuls and is
        latency-bound). The embedding gather touches only S rows and its
        gradient is a cheap per-block reduction — a per-row gather over
        S*N rows would backprop through a scatter-add over S*N rows.
        """
        s, n, xd = x.shape
        emb = params["emb"][jnp.clip(steps, 0, nbridges - 1)]  # (S, emb_dim)
        h = jnp.concatenate(
            [x, jnp.broadcast_to(emb[:, None, :], (s, n, emb.shape[-1]))],
            axis=-1,
        ).reshape(s * n, xd + emb.shape[-1])
        return _body(params, h).reshape(s, n, x_dim)

    apply_fn.apply_blocks = apply_blocks_fn
    return init_fn, apply_fn
