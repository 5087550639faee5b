"""Device meshes (port of ``repro/launch/mesh.py``).

The port's mesh is a small single-process object: an ordered map of
axis names to sizes over an array of ``torch.device``s, one a mesh
position.  It carries no process group: no op of the sharded flat bus
(``runtime/sharding.py``) has a collective in its per-shard body, so each
shard's kernel is launched on its own device from this one process.

A device may repeat, but only when the caller asks for it:
``make_pod_mesh(4, device="cuda")`` puts four shards on the current card
(and ``device="cpu"`` four on the CPU, as the reference's tests force
host devices), while ``devices=[...]`` names one device a position on a
host with several cards.  Only the one-card form has been run: no run on
several GPUs has been made.

Importing this module touches no device; every mesh is made by a
function call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def _concrete(device) -> torch.device:
    """``device`` resolved (raising without a card unless it is the CPU),
    a bare ``"cuda"`` pinned to the current card's index so that devices
    compare equal to the ones tensors report."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True, eq=False)
class Mesh:
    """``axis_names`` with ``axis_sizes`` in order; ``devices`` an object
    array of that shape holding one ``torch.device`` a position, or None
    for a mesh that only names a layout (``make_production_mesh``).  Two
    meshes are equal only when they are the same object."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[np.ndarray] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1, got "
                             f"{self.axis_sizes}")
        if (self.devices is not None
                and tuple(self.devices.shape) != tuple(self.axis_sizes)):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (the reference's
        ``mesh.shape``)."""
        return dict(zip(self.axis_names, (int(n) for n in self.axis_sizes)))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, every other axis at index 0: shard
        i of a buffer partitioned over ``axis`` lives on the i-th (it is
        replicated over the other axes, as the reference's ``P(axis)``
        places it)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}; axes "
                             f"{self.axis_names}")
        if self.devices is None:
            raise ValueError("this mesh names a layout and holds no devices")
        k = self.axis_names.index(axis)
        idx = [0] * len(self.axis_names)
        out = []
        for i in range(self.axis_sizes[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out


def _mesh(shape: Sequence[int], axes: Sequence[str], device,
          devices: Optional[Sequence]) -> Mesh:
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape))
    if devices is None:
        devs = [_concrete(device)] * n
    else:
        devs = [_concrete(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a mesh of {n} "
                             f"positions {shape}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(tuple(axes), shape, arr.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout, named without devices: 16 x 16
    = 256 chips a pod over ("data", "model"); ``multi_pod`` adds the
    2-pod axis in front.  The layout half of the mesh plans reads it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *, device="cuda",
                   devices: Optional[Sequence] = None) -> Mesh:
    """A small mesh: every position on ``device`` (the card unless the
    caller passes ``"cpu"``), or one of ``devices`` a position in
    row-major order."""
    return _mesh(shape, axes, device, devices)


def make_pod_mesh(n_pods: int, axis: str = "pod", *, device="cuda",
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh for the sharded flat bus (``core/flat.py``'s
    ``ShardedTreeSpec``): shard i of the bus, one contiguous BLOCK-padded
    segment, lives on position i, so the flat kernels run once a shard
    with no gather (``runtime/sharding.py``).  Every position is
    ``device`` unless ``devices`` names one each."""
    if n_pods < 1:
        raise ValueError(f"n_pods must be >= 1, got {n_pods}")
    return _mesh((n_pods,), (axis,), device, devices)
