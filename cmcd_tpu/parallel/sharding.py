"""Multi-chip chain parallelism.

The reference is strictly single-device (SURVEY.md §2c: no pmap/pjit/psum
anywhere). Chains are iid, so scaling is pure data parallelism over a 1-D
mesh: each device evolves its slice of the chain batch locally (shard_map),
and the scalar reductions (mean/variance for the losses, logsumexp for ln Z)
are XLA collectives, which run through NCCL over NVLink between the GPUs of
one host. Every GPU reaches every other at the same rate, so the mesh
follows the chain axis alone.

Params (variational dist, schedules, score nets) are tiny and replicated.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cmcd_tpu import bounds

CHAIN_AXIS = "chains"


def make_chain_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the chain axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (CHAIN_AXIS,), devices=devices)


def sharded_compute_elbos(params, key, n_chains: int, ctx, setup, mesh: Mesh):
    """compute_elbos with the chain batch sharded over the mesh.

    Each device draws its own chains from a fold_in(key, device_index) stream
    and runs the full integrator locally; outputs are sharded along the chain
    axis. Differentiable (shard_map supports autodiff), so the same function
    backs the sharded training losses.
    """
    ndev = mesh.shape[CHAIN_AXIS]
    if n_chains % ndev != 0:
        raise ValueError(f"n_chains={n_chains} not divisible by {ndev} devices")
    local_n = n_chains // ndev

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(),),
        out_specs=(P(CHAIN_AXIS), P(CHAIN_AXIS)),
    )
    def local(params):
        idx = jax.lax.axis_index(CHAIN_AXIS)
        local_key = jax.random.fold_in(key, idx)
        return bounds.compute_elbos(params, local_key, local_n, ctx, setup)

    # Eager shard_map needs the mesh context; set_mesh is illegal while
    # tracing (inside an outer jit the context is already established).
    try:
        ctx_mgr = jax.set_mesh(mesh)
    except ValueError:
        return local(params)
    with ctx_mgr:
        return local(params)


def sharded_kl_bound(params, key, n_chains, ctx, setup, *, mesh):
    """Mean negative ELBO over the sharded chain batch. The cross-device mean
    is a psum XLA inserts for the reduction over a sharded axis."""
    neg_elbos, z = sharded_compute_elbos(params, key, n_chains, ctx, setup, mesh)
    return jnp.mean(neg_elbos), (neg_elbos, z)


def sharded_var_bound(params, key, n_chains, ctx, setup, *, mesh):
    """VarGrad loss over the sharded chain batch (global variance)."""
    neg_elbos, z = sharded_compute_elbos(params, key, n_chains, ctx, setup, mesh)
    return jnp.clip(jnp.var(neg_elbos, ddof=0), -1e7, 1e7), (neg_elbos, z)


def sharded_loss_for_mode(mode: str, mesh: Mesh):
    """Drop-in loss_fn for cmcd_tpu.train.train with the chain axis sharded."""
    base = sharded_var_bound if "var" in mode else sharded_kl_bound
    return functools.partial(base, mesh=mesh)


def sequential_loss_for_mode(mode: str, n_shards: int):
    """The plain reference for sharded_loss_for_mode on n_shards devices:
    the same chain shards, drawn from the same fold_in(key, shard) streams,
    computed one after another in one program on one device."""

    def loss_fn(params, key, n_chains, ctx, setup):
        if n_chains % n_shards != 0:
            raise ValueError(f"n_chains={n_chains} not divisible by {n_shards}")
        parts = [
            bounds.compute_elbos(
                params, jax.random.fold_in(key, d), n_chains // n_shards,
                ctx, setup,
            )
            for d in range(n_shards)
        ]
        neg_elbos = jnp.concatenate([ne for ne, _ in parts])
        z = jnp.concatenate([zz for _, zz in parts])
        if "var" in mode:
            loss = jnp.clip(jnp.var(neg_elbos, ddof=0), -1e7, 1e7)
        else:
            loss = jnp.mean(neg_elbos)
        return loss, (neg_elbos, z)

    return loss_fn


def sharded_ln_z(neg_elbos):
    """ln Z = logsumexp(-neg_elbos) - log N over a (possibly sharded) batch.
    Under jit, XLA lowers the reduction to a max and a sum all-reduce."""
    n = neg_elbos.shape[0]
    return logsumexp(-neg_elbos) - jnp.log(n)


def replicate(tree, mesh: Mesh):
    """Place a pytree replicated on every device of the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)
