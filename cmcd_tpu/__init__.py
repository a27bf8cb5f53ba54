"""cmcd_tpu: a Controlled Monte Carlo Diffusions framework in JAX.

From-scratch JAX/XLA implementation of the capabilities of
shreyaspadhy/CMCD ("Transport meets Variational Inference: Controlled Monte
Carlo Diffusions", ICLR 2024): annealed-SDE bridges from a trainable
variational distribution to an unnormalized target, with KL and VarGrad
(log-variance) losses, score-network-controlled forward/backward kernels,
and ln Z / ELBO estimation.

Design: batch-first numerics (chains are a leading axis everywhere), a
single parameterized integrator family instead of per-mode modules, and
chain sharding over a jax.sharding.Mesh. The time loop is a lax.scan that
XLA compiles for whatever backend JAX runs on (GPU or CPU).
"""

__version__ = "0.1.0"

from cmcd_tpu.bounds import (
    CMCDSetup,
    compute_elbos,
    default_trainable,
    initialize,
    kl_bound,
    loss_fn_for_mode,
    var_bound,
)
from cmcd_tpu.targets import Target, load_target

__all__ = [
    "CMCDSetup",
    "Target",
    "compute_elbos",
    "default_trainable",
    "initialize",
    "kl_bound",
    "load_target",
    "loss_fn_for_mode",
    "var_bound",
]
