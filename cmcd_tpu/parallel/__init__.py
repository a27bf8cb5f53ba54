from cmcd_tpu.parallel.sharding import (
    CHAIN_AXIS,
    make_chain_mesh,
    replicate,
    sequential_loss_for_mode,
    sharded_compute_elbos,
    sharded_kl_bound,
    sharded_ln_z,
    sharded_loss_for_mode,
    sharded_var_bound,
)

__all__ = [
    "CHAIN_AXIS",
    "make_chain_mesh",
    "replicate",
    "sequential_loss_for_mode",
    "sharded_compute_elbos",
    "sharded_kl_bound",
    "sharded_ln_z",
    "sharded_loss_for_mode",
    "sharded_var_bound",
]
