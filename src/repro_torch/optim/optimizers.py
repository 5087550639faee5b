"""Adam on the flat bus (port of the flat path of
``repro/optim/optimizers.py``): params, m and v are three lanes of one
layout, updated by ONE fused kernel launch per step on the card."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np

from repro_torch.core.flat import FlatOptState, FlatParams, init_opt_state
from repro_torch.kernels import ops as K


@dataclass(frozen=True)
class Adam:
    lr: float | Callable[[int], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init_flat(self, fp: FlatParams) -> FlatOptState:
        """Zero moments sharing ``fp``'s TreeSpec, on ``fp``'s device."""
        return init_opt_state(fp.spec, fp.buf.device)

    def update_flat(self, grad_buf, state: FlatOptState, fp: FlatParams
                    ) -> Tuple[FlatParams, FlatOptState]:
        """Adam over the whole model as ONE pass over the flat bus.  The
        step count is a host int, and the bias corrections
        ``c1 = 1 - b1^t``, ``c2 = 1 - b2^t`` are taken in float32 on the
        host, as the reference does — no device scalar is ever read."""
        t = state.step + 1
        lr = self.lr(t) if callable(self.lr) else self.lr
        one, tt = np.float32(1.0), np.float32(t)
        c1 = one - np.float32(self.b1) ** tt
        c2 = one - np.float32(self.b2) ** tt
        new_buf, m, v = K.fused_adam_flat(
            fp.buf, grad_buf, state.m, state.v, lr, self.b1, self.b2,
            self.eps, self.weight_decay, c1, c2)
        return fp.with_buf(new_buf), FlatOptState(m=m, v=v, step=t,
                                                  spec=state.spec)
