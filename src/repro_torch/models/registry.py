"""Model facade (port of ``repro/models/registry.py``): the same entry
points for every architecture — the decoder-only stacks of
``transformer.py`` (the dense and MoE families, the VLM stub, rwkv6 and
jamba's hybrid mamba / attention / MoE stack) and the encoder-decoder of
``whisper.py``."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.common import ModelConfig
from repro_torch.models.plan import NULL_PLAN, require_one_card_plan


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
        init = W.init_whisper if self.cfg.is_enc_dec else T.init_lm
        return init(seed, self.cfg, resolve_device(device), cast)

    def param_specs(self):
        """The parameter tree of ``init`` (its layout, shapes and dtypes)
        as meta tensors: the init runs under the meta device, so nothing
        is drawn and nothing is allocated, at any size (the dry run's and
        the mesh plans' input)."""
        init = W.init_whisper if self.cfg.is_enc_dec else T.init_lm
        meta = torch.device("meta")
        with meta:
            return init(0, self.cfg, meta, False)

    def cache_specs(self, b: int, seq_len: int, plan=NULL_PLAN):
        """Meta tensors of the decode states ``prefill`` emits for ``b``
        prompts of ``seq_len`` positions under ``plan``."""
        if self.cfg.is_enc_dec:
            return W.whisper_cache_specs(self.cfg, b, seq_len, plan)
        return T.decode_cache_specs(self.cfg, b, seq_len, plan)

    def compute_params(self, params):
        """Matmul weights cast to the compute dtype once (see
        ``transformer.compute_params``)."""
        return T.compute_params(params, self.cfg)

    def loss(self, params, batch, plan=NULL_PLAN, remat: bool = True):
        """(loss, {"ce", "aux"}): ``transformer.lm_loss`` or
        ``whisper.whisper_loss``."""
        require_one_card_plan(plan)
        if self.cfg.is_enc_dec:
            return W.whisper_loss(params, self.cfg, batch, plan, remat=remat)
        return T.lm_loss(params, self.cfg, batch, plan, remat=remat)

    def forward(self, params, batch, plan=NULL_PLAN):
        require_one_card_plan(plan)
        if self.cfg.is_enc_dec:
            return W.whisper_forward(params, self.cfg, batch, plan)
        return T.lm_forward(params, self.cfg, batch, plan)[0]

    def prefill(self, params, batch, plan=NULL_PLAN):
        require_one_card_plan(plan)
        if self.cfg.is_enc_dec:
            return W.whisper_prefill(params, self.cfg, batch, plan)
        return T.lm_prefill(params, self.cfg, batch, plan)

    def decode_step(self, params, caches, token, pos, plan=NULL_PLAN):
        require_one_card_plan(plan)
        if self.cfg.is_enc_dec:
            return W.whisper_decode_step(params, self.cfg, caches, token,
                                         pos, plan)
        return T.lm_decode_step(params, self.cfg, caches, token, pos, plan)


def build_model(cfg: ModelConfig) -> Model:
    T.check_ported(cfg)
    return Model(cfg=cfg)
