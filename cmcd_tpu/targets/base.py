"""Target density interface.

Every target exposes a *batched* log-density: log_prob(z) with z (N, dim)
-> (N,). Tractable targets additionally expose sample(key, n) -> (n, dim)
and have ln Z == 0 exactly (normalized densities), which is the analytic
oracle the reference relies on (src/configs/base.py:74).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class Target:
    name: str
    dim: int
    log_prob: Callable  # (N, dim) -> (N,)
    sample: Optional[Callable] = None  # (key, n) -> (n, dim)
    # Construction kwargs (e.g. funnel sig, many_gmm n_mixes/loc_scaling),
    # recorded so tools can rebuild or inspect exactly this density.
    params: dict = dataclasses.field(default_factory=dict)

    @property
    def is_tractable(self) -> bool:
        return self.sample is not None
