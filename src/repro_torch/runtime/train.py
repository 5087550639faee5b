"""Flat-bus train step (port of ``repro/runtime/train.py::
make_flat_train_step``)."""
from __future__ import annotations

import torch

from repro_torch.core import flat as F


def make_flat_train_step(loss_fn, optimizer):
    """(FlatParams, FlatOptState, batch) -> (FlatParams', FlatOptState',
    loss).

    ``loss_fn(tree, batch)`` is differentiated w.r.t. the BUFFER: the tree
    it sees is views of the buffer (``F.unflatten``), so autograd returns
    the gradient lane directly, with an exactly-zero padding tail.  The
    optimizer then updates all three lanes in one pass (one fused kernel
    launch on the card)."""

    def step(fp: F.FlatParams, fos: F.FlatOptState, batch):
        buf = fp.buf.detach().requires_grad_(True)
        loss = loss_fn(F.unflatten(fp.with_buf(buf)), batch)
        (gbuf,) = torch.autograd.grad(loss, buf)
        new_fp, new_fos = optimizer.update_flat(gbuf, fos, fp)
        return new_fp, new_fos, loss.detach()

    return step
