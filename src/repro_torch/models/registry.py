"""Model facade (port of ``repro/models/registry.py``): the same entry
points for every architecture the port runs — so far the dense
transformer family, rwkv6 and the hybrid mamba / attention / MoE stack
of jamba."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.models.plan import NULL_PLAN


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device="cuda", cast: bool = False):
        """Random parameters (the reference's distributions: he_normal /
        lecun_normal std, ones for norm scales, zeros for biases) drawn
        from a CPU ``torch.Generator`` seeded with ``seed``, placed on
        ``device`` (the card unless the caller names the CPU).  ``cast``:
        the matmul weights arrive in the compute dtype, as
        ``compute_params`` would give them, never held on ``device`` in
        the parameter dtype."""
        return T.init_lm(seed, self.cfg, resolve_device(device), cast)

    def compute_params(self, params):
        """Matmul weights cast to the compute dtype once (see
        ``transformer.compute_params``)."""
        return T.compute_params(params, self.cfg)

    def forward(self, params, batch, plan=NULL_PLAN):
        return T.lm_forward(params, self.cfg, batch, plan)[0]

    def prefill(self, params, batch, plan=NULL_PLAN):
        return T.lm_prefill(params, self.cfg, batch, plan)

    def decode_step(self, params, caches, token, pos, plan=NULL_PLAN):
        return T.lm_decode_step(params, self.cfg, caches, token, pos, plan)


def build_model(cfg: ModelConfig) -> Model:
    T.check_ported(cfg)
    return Model(cfg=cfg)
