"""Server parameter-update schemes (port of ``repro/core/baselines.py``).

Only VC-ASGD is ported so far: Eq. 1 per arriving result, with the
alpha schedule evaluated per epoch and optional staleness damping.  The
other six schemes of the reference come with later slices.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core import vc_asgd as V
from repro_torch.protocol.scheme import ServerScheme
from repro_torch.protocol.types import ResultMeta

__all__ = ["VCASGD"]


class VCASGD(ServerScheme):
    def __init__(self, alpha: float | Callable[[int], float] = 0.95,
                 staleness_gamma: Optional[float] = None):
        self.alpha = alpha if callable(alpha) else V.const_alpha(alpha)
        self.staleness_gamma = staleness_gamma
        self.name = "vc-asgd"

    def assimilate(self, state, payload, meta: ResultMeta):
        a = self.alpha(meta.epoch)
        if self.staleness_gamma is not None:
            a = V.staleness_alpha(a, meta.staleness, self.staleness_gamma)
        fp = state.params
        c_buf = self._payload_buf(fp, payload)
        state.params = V.vc_asgd_update_flat(fp, c_buf, a)
        state.version += 1
        return state
