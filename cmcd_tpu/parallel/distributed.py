"""Multi-host setup helpers.

The reference is single-process (SURVEY.md §2c). For runs across hosts the
chain axis extends over every process: call initialize_distributed() once per
process before any JAX computation, then build the chain mesh over
jax.devices() — NVLink between the GPUs of a host, the network between
hosts. Chains are iid, so the only cross-device traffic is the loss/lnZ
reductions (scalars per device).
"""

from __future__ import annotations

import jax


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """jax.distributed.initialize.

    Without arguments JAX reads them from a cluster manager's environment
    (e.g. SLURM); on a machine with none, pass the coordinator address
    (`host:port`), the number of processes and this process's id.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


def global_chain_mesh():
    """1-D mesh over every addressable device across all hosts."""
    from cmcd_tpu.parallel.sharding import CHAIN_AXIS

    return jax.make_mesh((jax.device_count(),), (CHAIN_AXIS,))
