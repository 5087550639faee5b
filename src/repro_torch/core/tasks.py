"""Laptop-scale training tasks for the VC simulator (port of
``repro/core/tasks.py``).

The data generators are numpy and copied verbatim, so the arrays are
byte-identical to the reference's.  ``MLPTask`` keeps the reference's leaf
names and layouts (``w1 [dim, 128]``, ``x @ w1 + b1``, ...) and trains on
the flat bus: every client step is one autograd pass w.r.t. the bus
buffer plus ONE fused Adam launch (``runtime/train.py``).  ``CNNTask`` is
the small conv net on [res, res, 3] images, with the reference's NHWC
inputs and HWIO kernels, on the same bus and the same Adam.

Random draws (He-normal init, minibatch indices) come from CPU
``torch.Generator``s and are moved to the device afterwards, so a CPU run
and a card run see the same draws.  They cannot reproduce ``jax.random``'s
bits; tests inject the reference's draws through ``batch_indices`` and
``repro_torch.convert``.

float32 matmuls and convolutions run in full float32:
``torch.backends.cuda.matmul.allow_tf32`` (and, for ``CNNTask``,
``torch.backends.cudnn.allow_tf32``) is set to False when a task is built
(TF32 would keep only about three decimal digits and drift from the CPU
run).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from repro_torch.core import flat as F
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Adam
from repro_torch.runtime.train import make_flat_train_step


@dataclass(frozen=True)
class TaskData:
    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray


def make_classification_data(n_train: int = 5000, n_val: int = 1000,
                             dim: int = 32, n_classes: int = 10,
                             seed: int = 0) -> TaskData:
    """Teacher-MLP labeled Gaussian features + label noise -> learnable but
    not saturating instantly (mirrors CIFAR10's ~0.73/0.82 plateau shape)."""
    rng = np.random.default_rng(seed)
    n = n_train + n_val
    x = rng.standard_normal((n, dim)).astype(np.float32)
    w1 = rng.standard_normal((dim, 64)).astype(np.float32) / np.sqrt(dim)
    w2 = rng.standard_normal((64, n_classes)).astype(np.float32) / 8.0
    logits = np.maximum(x @ w1, 0) @ w2
    y = logits.argmax(-1).astype(np.int32)
    flip = rng.random(n) < 0.08                       # 8% label noise
    y[flip] = rng.integers(0, n_classes, flip.sum())
    return TaskData(x[:n_train], y[:n_train], x[n_train:], y[n_train:])


def make_image_data(n_train: int = 5000, n_val: int = 1000, res: int = 8,
                    n_classes: int = 10, seed: int = 0) -> TaskData:
    rng = np.random.default_rng(seed)
    n = n_train + n_val
    x = rng.standard_normal((n, res, res, 3)).astype(np.float32)
    # class templates + noise
    templates = rng.standard_normal((n_classes, res, res, 3)).astype(np.float32)
    y = rng.integers(0, n_classes, n).astype(np.int32)
    x = 0.8 * x + 1.2 * templates[y]
    return TaskData(x[:n_train], y[:n_train], x[n_train:], y[n_train:])


# jax.nn.initializers.he_normal: truncated normal on [-2, 2], rescaled so
# the truncated distribution has std sqrt(2 / fan_in)
_TRUNC_STD = 0.87962566103423978


def _initializers(seed: int, dev: torch.device):
    """(he, zeros): He-normal draws from one CPU generator seeded with
    ``seed`` (fan-in = every dim but the last, as jax's ``he_normal``
    counts it for a dense or an HWIO kernel), moved to ``dev``."""
    gen = torch.Generator().manual_seed(seed)

    def he(shape):
        t = torch.empty(shape, dtype=torch.float32)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        fan_in = math.prod(shape[:-1])
        return (t * (math.sqrt(2.0 / fan_in) / _TRUNC_STD)).to(dev)

    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    return he, zeros


class MLPTask(nn.Module):
    """dim -> 128 -> 64 -> n_classes MLP, Adam client training on the flat
    bus.  Functional: parameters live on the bus, not in the module."""

    def __init__(self, dim: int = 32, n_classes: int = 10, lr: float = 1e-3,
                 batch: int = 50):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = False
        self.dim, self.n_classes, self.lr, self.batch = dim, n_classes, lr, batch
        self.opt = Adam(lr=lr)
        self._step = make_flat_train_step(
            lambda p, b: self.loss(p, b[0], b[1]), self.opt)

    def init_params(self, seed: int, device="cuda") -> dict:
        """He-normal weights, zero biases; drawn on the CPU from ``seed``."""
        dev = resolve_device(device)
        he, zeros = _initializers(seed, dev)
        d, h1, h2, c = self.dim, 128, 64, self.n_classes
        return {"w1": he((d, h1)), "b1": zeros(h1),
                "w2": he((h1, h2)), "b2": zeros(h2),
                "w3": he((h2, c)), "b3": zeros(c)}

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ p["w1"] + p["b1"])
        h = torch.relu(h @ p["w2"] + p["b2"])
        return h @ p["w3"] + p["b3"]

    def loss(self, p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        lp = torch.log_softmax(self(p, x), dim=-1)
        return -lp.gather(1, y[:, None]).mean()

    def batch_indices(self, seed: int, steps: int, n: int) -> torch.Tensor:
        """[steps, batch] minibatch row indices into a shard of ``n`` rows,
        drawn on the CPU from ``seed`` (override to inject other draws)."""
        gen = torch.Generator().manual_seed(seed)
        return torch.randint(0, n, (steps, self.batch), generator=gen)

    def client_train(self, base: F.FlatParams, x: torch.Tensor,
                     y: torch.Tensor, *, steps: int, seed: int
                     ) -> torch.Tensor:
        """One subtask's client training: ``steps`` Adam minibatch steps
        from fresh moments, on the bus's device.  Returns the trained
        buffer (same layout as ``base``)."""
        idx = self.batch_indices(seed, steps, x.shape[0]).to(x.device)
        fp, fos = base, self.opt.init_flat(base)
        for i in range(steps):
            fp, fos, _ = self._step(fp, fos, (x[idx[i]], y[idx[i]]))
        return fp.buf

    @torch.no_grad()
    def evaluate(self, params: dict, x: torch.Tensor, y: torch.Tensor
                 ) -> float:
        return float((self(params, x).argmax(-1) == y).float().mean())


class CNNTask(MLPTask):
    """Small conv net on [res, res, 3] images (ResNet stand-in): two SAME
    3x3 convolutions, each followed by ReLU and a VALID 2x2 max-pool, then
    a 64-wide dense layer and the classifier.  Inputs are NHWC (flat rows
    of res * res * 3 are accepted too) and kernels HWIO, as in the
    reference; ``conv2d`` / ``max_pool2d`` run on the permuted NCHW /
    OIHW layouts, and the pooled map is flattened in NHWC order."""

    def __init__(self, res: int = 8, n_classes: int = 10, lr: float = 1e-3,
                 batch: int = 50):
        self.res = res
        super().__init__(dim=res * res * 3, n_classes=n_classes, lr=lr,
                         batch=batch)
        torch.backends.cudnn.allow_tf32 = False

    def init_params(self, seed: int, device="cuda") -> dict:
        """He-normal kernels and weights, zero biases; drawn on the CPU
        from ``seed``."""
        he, zeros = _initializers(seed, resolve_device(device))
        c = self.n_classes
        return {"c1": he((3, 3, 3, 16)), "bc1": zeros(16),
                "c2": he((3, 3, 16, 32)), "bc2": zeros(32),
                "w": he(((self.res // 4) ** 2 * 32, 64)), "b": zeros(64),
                "w2": he((64, c)), "b2": zeros(c)}

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], self.res, self.res, 3).permute(0, 3, 1, 2)
        for k, b in (("c1", "bc1"), ("c2", "bc2")):
            h = TF.conv2d(h, p[k].permute(3, 2, 0, 1), padding=1)
            h = torch.relu(h + p[b][:, None, None])
            h = TF.max_pool2d(h, 2, 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = torch.relu(h @ p["w"] + p["b"])
        return h @ p["w2"] + p["b2"]
