"""Device meshes of one process; the port of ``vilgod_tpu/parallel/mesh.py``.

The JAX package's stage meshes are host-local: one controller drives every
local chip through ``shard_map``, and processes split only the sequence
list (``pipeline/runner.run_sequences``). The port keeps that split. A
:class:`Mesh` is an ordered tuple of local ``torch.device``s; a sharded
function enqueues each shard's body on its own device from this one
process, so shards on different cards overlap wherever the body does not
wait for the host. A device may repeat (D logical shards on one card, or
on the CPU), as the JAX package's tests run on virtual CPU devices.
"""
from __future__ import annotations

import torch

from ..utils.common import resolve_device


def _indexed(device) -> torch.device:
    """``device`` with its card's index (``cuda`` is the current card), so
    that equal devices compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A 1-D mesh: ``devices`` in shard order along the axis ``axis``;
    ``mesh.shape[axis]`` is the shard count, as in JAX."""

    def __init__(self, devices, axis: str = "dp"):
        self.devices = tuple(_indexed(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)
        self.shape = {axis: len(self.devices)}


def local_devices(device) -> list[torch.device]:
    """The devices a stage of a sequence on ``device`` shards over: for a
    CUDA device every visible card, that device's first; otherwise
    ``[device]`` (one shard, so no stage takes its mesh branch)."""
    device = _indexed(device)
    if device.type != "cuda":
        return [device]
    return [device] + [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())
                       if i != device.index]


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (by default
    the visible cards, ``cuda:0`` first; without a card this raises)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, axis)


class Sharding:
    """How a tensor lies on a mesh: split along dim 0 over ``axis`` (the
    JAX package's ``P(axis)``) or, with ``axis=None``, whole on every shard
    (``P()``)."""

    def __init__(self, mesh: Mesh, axis: str | None):
        self.mesh, self.axis = mesh, axis

    def put(self, t: torch.Tensor) -> list[torch.Tensor]:
        """The per-shard tensors of ``t``, each on its shard's device:
        contiguous dim-0 chunks (dim 0 must divide over the mesh), or one
        copy per distinct device, shared by the shards on that device."""
        devices = self.mesh.devices
        if self.axis is None:
            copies: dict[torch.device, torch.Tensor] = {}
            for dev in devices:
                if dev not in copies:
                    copies[dev] = t.to(dev)
            return [copies[dev] for dev in devices]
        d = self.mesh.shape[self.axis]
        if t.shape[0] % d:
            raise ValueError(f"dim 0 ({t.shape[0]}) must divide over the "
                             f"mesh ({d})")
        c = t.shape[0] // d
        return [t[i * c:(i + 1) * c].to(dev) for i, dev in enumerate(devices)]


def frame_sharding(mesh: Mesh, axis: str = "dp") -> Sharding:
    """Shard the leading (frame / batch) dimension over the mesh."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)
