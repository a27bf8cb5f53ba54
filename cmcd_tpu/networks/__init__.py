"""Score/drift network architectures.

Reference parity (src/nn.py, src/nn_dds.py) with a batch-first apply
signature: apply(params, x, i) takes x of shape (N, x_dim + rho_dim) and the
bridge index i (int32 scalar), returning (N, x_dim). The batched layout makes
every layer a single (N, in) @ (in, out) matmul instead of N vmapped
vector-matrix products.
"""

from cmcd_tpu.networks.geffner import build_geffner_network
from cmcd_tpu.networks.pis import build_pis_network, build_pis_grad_network


def build_score_network(
    x_dim: int,
    emb_dim: int,
    nbridges: int,
    rho_dim: int = 0,
    nlayers: int = 2,
    arch: str = "geffner",
    fully_connected_units=None,
    target_log_prob=None,
):
    """Network factory mirroring reference src/nn.py:21-39.

    Returns (init_fn, apply_fn):
      init_fn(key) -> params pytree
      apply_fn(params, x, i) -> (N, x_dim), x: (N, x_dim + rho_dim)

    arch in {"geffner", "dds", "dds_grad"}. The reference's "dds_grad" path is
    broken as shipped (undefined LinearConsInit, src/nn_dds.py:245); here it is
    implemented working, with the grad feature closed over target_log_prob.
    """
    if arch == "geffner":
        return build_geffner_network(
            x_dim, emb_dim, nbridges, rho_dim=rho_dim, nlayers=nlayers
        )
    if arch == "dds":
        return build_pis_network(
            x_dim, fully_connected_units or [64, 64], rho_dim=rho_dim
        )
    if arch == "dds_grad":
        if target_log_prob is None:
            raise ValueError("dds_grad arch needs target_log_prob for its grad feature")
        return build_pis_grad_network(
            x_dim,
            fully_connected_units or [64, 64],
            rho_dim=rho_dim,
            target_log_prob=target_log_prob,
        )
    raise ValueError(f"Unknown nn arch: {arch}")
