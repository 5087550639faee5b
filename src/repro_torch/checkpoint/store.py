"""Checkpointing (port of ``repro/checkpoint/store.py``): a msgpack tensor
store with atomic rename, async save, retention and restart logic.

The server copy is the only state of the VC design that must survive
(clients are disposable by design), so a checkpoint is a snapshot of
(server params, optimizer state, step, the caller's counters), and
``CheckpointManager.restore_or_init`` is what a launcher calls first.

The files are the reference's, byte for byte in every record and field
for field in every header (apart from ``treedef``, a string readers
ignore): either package restores the other's checkpoints.  Three kinds:

* a tree of tensors: a header (``treedef``, one ``{dtype, shape}`` a
  leaf, ``extra``) and one msgpack bin a leaf;
* a FlatParams: a header (``flat`` layout, ``buf_dtype``, ``treedef``,
  ``extra``) and the bus as ONE bin;
* a one-pass train record: a header (``kind: "flat-train"``, layout,
  ``buf_dtype``, ``lane_bytes``, ``step``, ...) and ``[params | m | v]``
  as ONE contiguous bin, so training state restores from one read.

bf16 rides as its uint16 bits.  Writes go to a temp file in the same
directory, then ``os.replace``: a reader never sees a torn record.  A
load puts its tensors on ``device`` when given, else on the device of
``like``'s tensors, else on the card.  The msgpack subset is the port's
own (``_msgpack.py``).
"""
from __future__ import annotations

import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack as M
from repro_torch.core import flat as F
from repro_torch.device import resolve_device


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy in host memory, taken now: the caller may write
    to ``t`` (or the card may) as soon as this returns."""
    return t.detach().to("cpu", copy=True).contiguous()


def _lane(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(dtype name, the bytes of host tensor ``t`` as a numpy view); bf16
    as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy()
    return F.dtype_name(t.dtype), t.numpy()


def _tensor(raw, dtype_name: str, shape, device: torch.device,
            offset: int = 0, nbytes: Optional[int] = None) -> torch.Tensor:
    """``nbytes`` of ``raw`` from ``offset`` as a tensor of ``dtype_name``
    and ``shape`` on ``device`` (no copy before the move)."""
    bf16 = dtype_name == "bfloat16"
    dt = np.dtype(np.uint16 if bf16 else dtype_name)
    count = -1 if nbytes is None else nbytes // dt.itemsize
    arr = np.frombuffer(raw, dt, count=count, offset=offset)
    t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.reshape(tuple(shape)).to(device)


def _write(path, header: Dict, records: Sequence[Sequence[np.ndarray]]
           ) -> None:
    """Atomic write of ``header`` then one msgpack bin a record, a record
    being the concatenation of its lanes (written lane by lane, never
    joined in memory)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(M.packb(header))
            for lanes in records:
                f.write(M.bin_header(sum(a.nbytes for a in lanes)))
                for a in lanes:
                    f.write(a)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _read(path, n_records: int) -> Tuple[Dict, List]:
    """(header, the ``n_records`` objects after it)."""
    with open(path, "rb") as f:
        it = M.Unpacker(f)
        header = next(it)
        records = [next(it) for _ in range(n_records)]
    return header, records


def _device(like, device) -> torch.device:
    """``device`` if given, else the device of ``like``'s first tensor,
    else the card."""
    if device is not None:
        return resolve_device(device)
    if isinstance(like, F.FlatParams):
        return like.buf.device
    if not isinstance(like, F.TreeSpec):
        leaves, _ = F.tree_flatten(like)
        if leaves and isinstance(leaves[0], torch.Tensor):
            return leaves[0].device
    return resolve_device("cuda")


# ---------------------------------------------------------------------------
# a tree of tensors: one bin a leaf
# ---------------------------------------------------------------------------

def save_checkpoint(path, tree, extra: Optional[Dict] = None) -> None:
    """Atomic save of a tree of tensors, one bin a leaf."""
    leaves, treedef = F.tree_flatten(tree)
    metas, lanes = [], []
    for leaf in leaves:
        host = _host(leaf)
        name, raw = _lane(host)
        metas.append({"dtype": name, "shape": list(host.shape)})
        lanes.append([raw])
    _write(path, {"treedef": str(treedef), "metas": metas,
                  "extra": extra or {}}, lanes)


def load_checkpoint(path, tree_like, device=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (its treedef; each
    leaf's dtype and shape come from the record)."""
    leaves, treedef = F.tree_flatten(tree_like)
    dev = _device(tree_like, device)
    header, bufs = _read(path, len(leaves))
    out = [_tensor(buf, meta["dtype"], meta["shape"], dev)
           for meta, buf in zip(header["metas"], bufs)]
    return F.tree_unflatten(treedef, out), header.get("extra", {})


# ---------------------------------------------------------------------------
# flat-bus checkpoints: the layout in the header, the bus as ONE bin
# ---------------------------------------------------------------------------

def checkpoint_extra(path) -> Dict:
    """The ``extra`` dict of a record, read from its header alone."""
    return _read(path, 0)[0].get("extra", {})


def save_flat_checkpoint(path, fp: F.FlatParams,
                         extra: Optional[Dict] = None) -> None:
    """Atomic save of a FlatParams: header (layout + extra) + one bin."""
    buf_dtype, raw = _lane(_host(fp.buf))
    header = {"flat": fp.spec.meta(), "buf_dtype": buf_dtype,
              "treedef": str(fp.spec.treedef), "extra": extra or {}}
    _write(path, header, [[raw]])


def _spec_of(like) -> F.TreeSpec:
    if isinstance(like, F.FlatParams):
        return like.spec
    if isinstance(like, F.TreeSpec):
        return like
    return F.tree_spec(like)


def _check_layout(meta: Dict, spec: F.TreeSpec, path) -> None:
    """The record's layout must be ``spec``'s.  A sharded layout
    (``ShardedTreeSpec``) pins the segment geometry: a record written
    n_shards-way restores only onto the same partitioning.  Checked first,
    so the error names the shard layout (the padded length usually
    differs too)."""
    want = None
    if isinstance(spec, F.ShardedTreeSpec):
        want = {"n_shards": spec.n_shards, "shard_len": spec.shard_len,
                "axis": spec.axis}
    have = meta.get("shard")
    if want != have:
        raise ValueError(f"flat checkpoint shard-layout mismatch: record "
                         f"{have} vs requested {want}: {path}")
    if (tuple(tuple(s) for s in meta["shapes"]) != spec.shapes
            or tuple(meta["offsets"]) != spec.offsets
            or meta["n"] != spec.n or meta["padded"] != spec.padded):
        raise ValueError(f"flat checkpoint layout mismatch: {path}")


def load_flat_checkpoint(path, like, device=None
                         ) -> Tuple[F.FlatParams, Dict]:
    """Restore a FlatParams saved by ``save_flat_checkpoint``.  ``like``
    (a FlatParams, a TreeSpec or a template tree) supplies the layout the
    record is checked against (mismatch -> ValueError) and the treedef."""
    spec = _spec_of(like)
    header, (raw,) = _read(path, 1)
    if header.get("kind") == "flat-train":
        raise ValueError(f"{path} is a train checkpoint (params+m+v); "
                         f"use load_train_checkpoint")
    _check_layout(header["flat"], spec, path)
    buf = _tensor(raw, header["buf_dtype"], (-1,), _device(like, device))
    return F.FlatParams(buf, spec), header.get("extra", {})


# ---------------------------------------------------------------------------
# one-pass TRAIN checkpoints: params + Adam m / v as three lanes of ONE
# contiguous record, written and restored in one pass
# ---------------------------------------------------------------------------

def save_train_checkpoint(path, fp: F.FlatParams, opt: F.FlatOptState,
                          extra: Optional[Dict] = None) -> None:
    """Atomic save of (FlatParams, FlatOptState): one header + ONE
    contiguous record laid out as ``[params | m | v]``."""
    if fp.spec.padded != opt.spec.padded or fp.spec.shapes != opt.spec.shapes:
        raise ValueError("params and optimizer state do not share a layout")
    p_dtype, p = _lane(_host(fp.buf))
    m = _host(opt.m.to(torch.float32)).numpy()
    v = _host(opt.v.to(torch.float32)).numpy()
    header = {"kind": "flat-train", "flat": fp.spec.meta(),
              "buf_dtype": p_dtype,
              "lane_bytes": [p.nbytes, m.nbytes, v.nbytes],
              "step": int(opt.step), "treedef": str(fp.spec.treedef),
              "extra": extra or {}}
    _write(path, header, [[p, m, v]])


def load_train_checkpoint(path, like, device=None
                          ) -> Tuple[F.FlatParams, F.FlatOptState, Dict]:
    """Restore (FlatParams, FlatOptState, extra) saved by
    ``save_train_checkpoint``; ``like`` as in ``load_flat_checkpoint``.
    The record is cut into its three lanes by the header's byte counts —
    no per-leaf unpacking."""
    spec = _spec_of(like)
    header, (record,) = _read(path, 1)
    if header.get("kind") != "flat-train":
        raise ValueError(f"{path} is not a train checkpoint; "
                         f"use load_flat_checkpoint")
    _check_layout(header["flat"], spec, path)
    lp, lm, lv = header["lane_bytes"]
    if len(record) != lp + lm + lv:
        raise ValueError(f"torn train checkpoint record: {path}")
    dev = _device(like, device)
    buf = _tensor(record, header["buf_dtype"], (-1,), dev, 0, lp)
    m = _tensor(record, "float32", (-1,), dev, lp, lm)
    v = _tensor(record, "float32", (-1,), dev, lp + lm, lv)
    opt = F.FlatOptState(m=m, v=v, step=int(header["step"]), spec=spec)
    return F.FlatParams(buf, spec), opt, header.get("extra", {})


class CheckpointManager:
    """Rolling checkpoints ``ckpt_{step:08d}.msgpack`` in ``directory``,
    the newest ``keep`` retained.

    ``save`` takes its snapshot on the caller's thread — a copy of every
    tensor into host memory before it returns, so the caller's next step
    may reuse the buffers — and, with ``async_save``, writes the file on a
    background thread (one at a time: the next save, restore or ``wait``
    joins it and re-raises what it raised)."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.msgpack"

    def _submit(self, write) -> None:
        """Run ``write`` (then retention) now, or on the background
        thread."""
        def work():
            try:
                write()
                self._gc()
            except BaseException as e:          # re-raised by wait()
                self._error = e

        if self.async_save:
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()
        else:
            work()
            self._raise()

    def _raise(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        """Snapshot a FlatParams (flat record) or a tree of tensors."""
        self.wait()
        path = self._path(step)
        if isinstance(tree, F.FlatParams):
            snap = tree.with_buf(_host(tree.buf))
            self._submit(lambda: save_flat_checkpoint(path, snap, extra))
        else:
            snap = F.tree_map(_host, tree)
            self._submit(lambda: save_checkpoint(path, snap, extra))

    def save_train(self, step: int, fp: F.FlatParams, opt: F.FlatOptState,
                   extra: Optional[Dict] = None) -> None:
        """One-pass (params + m + v) snapshot; the rules of ``save``."""
        self.wait()
        path = self._path(step)
        snap_fp = fp.with_buf(_host(fp.buf))
        snap_opt = F.FlatOptState(m=_host(opt.m), v=_host(opt.v),
                                  step=int(opt.step), spec=opt.spec)
        self._submit(lambda: save_train_checkpoint(path, snap_fp, snap_opt,
                                                   extra))

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._raise()

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("ckpt_*.msgpack"))
        for old in ckpts[:-self.keep]:
            old.unlink(missing_ok=True)

    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("ckpt_*.msgpack"))
        if not ckpts:
            return None
        return int(ckpts[-1].stem.split("_")[1])

    def restore_or_init(self, tree_like, init_fn, device=None):
        """Resume from the newest checkpoint or initialize fresh.  Returns
        (tree, extra, step)."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return init_fn(), {}, 0
        if isinstance(tree_like, (F.FlatParams, F.TreeSpec)):
            tree, extra = load_flat_checkpoint(self._path(step), tree_like,
                                               device)
        else:
            tree, extra = load_checkpoint(self._path(step), tree_like,
                                          device)
        return tree, extra, step

    def restore_train_or_init(self, like, init_fn, device=None):
        """Resume (params, opt state) from the newest train checkpoint or
        initialize fresh.  Returns ((fp, opt), extra, step)."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return init_fn(), {}, 0
        fp, opt, extra = load_train_checkpoint(self._path(step), like,
                                               device)
        return (fp, opt), extra, step

    # -- protocol server checkpoints (protocol/coordinator.py hooks): the
    # durable VC state is (server params, version); the version rides the
    # header's extra

    def save_server(self, step: int, fp: F.FlatParams, version: int,
                    extra: Optional[Dict] = None) -> None:
        e = dict(extra or {})
        e["server_version"] = int(version)
        self.save(step, fp, e)

    def restore_server_or_init(self, like, init_fn, device=None):
        """Resume (params, version) from the newest checkpoint or init
        fresh.  Returns (params, version, extra, step); ``extra`` is the
        dict ``save_server`` persisted, so a runtime can resume its own
        counters."""
        tree, extra, step = self.restore_or_init(like, init_fn, device)
        return tree, int(extra.get("server_version", 0)), extra, step
