"""A single-controller device mesh and the placement helpers over it.

Counterpart of ``montecarlo_gated_mil_tpu/parallel/mesh.py``.  The JAX mesh
is single-controller: one process owns every device, and XLA places the
shards and inserts the collectives.  Here a :class:`Mesh` is an explicit
``(data, inst)`` grid of ``torch.device``s driven by one process; the code
that uses it moves each shard to its device and reduces across shards
itself, on the first device of the axis and in shard order
(:func:`reduce_shards`, :func:`gather_shards`), so a result does not
depend on timing.

A device may appear more than once.  A mesh of ``[torch.device("cpu")] * 8``
runs the sharded paths in the tests, as JAX's eight virtual CPU devices do;
``[torch.device("cuda", 0)] * 4`` runs them on one card, launching the real
kernels.  On repeated devices the shards share one memory and one stream, so
such a mesh checks the arithmetic and the launches, not the transfers or the
memory split of distinct cards.

``data_sharded`` and ``replicated`` keep their JAX names, as the placements
the port uses: a tensor's leading axis split over ``data``, and a module
copied to each device of an axis.  :func:`instance_mesh` and
:func:`shard_mesh_for` are the routing policy of oversized bags (JAX's
``train/loops.py::_instance_mesh``, ``_shard_mesh_for``), shared by the eval
loops, the data-parallel test and the predictor.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Sequence

import torch

from montecarlo_gated_mil_tpu_torch.parallel.distributed import process_count

AXES = ("data", "inst")


@dataclass(frozen=True)
class Mesh:
    """``grid[d][i]`` is the device of data index ``d`` and instance shard
    ``i``."""

    grid: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.grid), "inst": len(self.grid[0])}

    @property
    def size(self) -> int:
        """The number of devices, repeats counted."""
        return len(self.grid) * len(self.grid[0])

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of the other axis: where
        shard ``s`` of that axis lives."""
        if axis == "data":
            return [row[0] for row in self.grid]
        if axis == "inst":
            return list(self.grid[0])
        raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")

    def flat(self, axis: str) -> "Mesh":
        """The same devices, all on ``axis`` (the other axis of size 1)."""
        if axis not in AXES:
            raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")
        devs = [dev for row in self.grid for dev in row]
        if axis == "inst":
            return make_mesh(data=1, inst=len(devs), devices=devs)
        return make_mesh(data=len(devs), devices=devs)


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(data: int = -1, inst: int = 1, devices: Sequence | None = None) -> Mesh:
    """Mesh with axes ``(data, inst)``; ``data=-1`` takes every device left.

    ``devices=None`` means every visible CUDA device, and raises when there
    is none: a CPU mesh is only ever asked for by name.  ``devices`` may
    repeat a device."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= for a CPU mesh, "
                "e.g. [torch.device('cpu')] * 8"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    devs = [_device(d) for d in devices]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh: no devices given")
    if inst <= 0:
        raise ValueError(f"inst axis must be positive, got {inst}")
    if n % inst:
        raise ValueError(f"{n} devices not divisible by inst={inst}")
    if data == -1:
        data = n // inst
    if data * inst != n:
        raise ValueError(f"data*inst = {data * inst} != {n} devices")
    return Mesh(tuple(tuple(devs[d * inst:(d + 1) * inst]) for d in range(data)))


def instance_mesh() -> Mesh | None:
    """Every visible CUDA device on the ``inst`` axis, for routing oversized
    bags; None with fewer than two devices or under multi-process fold
    fan-out (each process evaluates other folds, so a mesh over all
    processes' devices would not be one program)."""
    if process_count() > 1 or not torch.cuda.is_available() or torch.cuda.device_count() <= 1:
        return None
    return make_mesh(data=1, inst=torch.cuda.device_count())


def shard_mesh_for(bucket: int, shard_over: int | None, mesh: Mesh | None = None) -> Mesh | None:
    """The instance mesh over all of ``mesh``'s devices (default
    :func:`instance_mesh`) when a bag of ``bucket`` should shard, else None:
    not oversized (``bucket <= shard_over``), routing off, one device, or a
    bucket that does not divide over the devices."""
    if shard_over is None or bucket <= shard_over:
        return None
    mesh = instance_mesh() if mesh is None else mesh.flat("inst")
    if mesh is None or mesh.size <= 1 or bucket % mesh.size:
        return None
    return mesh


def replicated(mesh: Mesh, module: torch.nn.Module, axis: str = "data") -> list[torch.nn.Module]:
    """``module`` on each device of ``axis``: the module itself where it
    already lives, else one copy per distinct device, which repeats of that
    device share.  The copies are taken now, so later changes to
    ``module``'s weights do not reach them."""
    own = next(module.parameters()).device
    copies = {own: module}
    out = []
    for dev in mesh.axis_devices(axis):
        if dev not in copies:
            copies[dev] = copy.deepcopy(module).to(dev)
        out.append(copies[dev])
    return out


def refresh_replicas(module: torch.nn.Module, replicas: Sequence[torch.nn.Module]) -> None:
    """Copy ``module``'s weights into each of ``replicas`` that is a
    separate copy: the training steps call it before every step, since only
    ``module`` (on the first device, beside the optimizer) is updated.
    Replicas that are ``module`` itself cost nothing."""
    params = list(module.parameters())
    with torch.no_grad():
        for r in {id(r): r for r in replicas if r is not module}.values():
            for dst, src in zip(r.parameters(), params):
                dst.copy_(src)


def data_sharded(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """``x``'s leading axis split evenly over ``data``: part ``d`` on data
    device ``d`` (the rest of each part whole)."""
    devices = mesh.axis_devices("data")
    if x.shape[0] % len(devices):
        raise ValueError(f"leading axis {x.shape[0]} not divisible by data={len(devices)}")
    return [part.to(dev) for part, dev in zip(torch.chunk(x, len(devices)), devices)]


def shard_batch(mesh: Mesh, batch):
    """A stacked batch of bags (:func:`core.bag.stack_bags`) placed over
    ``data``: a list with, for each data device, the bag of its slice of
    the leading axis on that device."""
    fields = ("patches", "mask", "label", "tile_indices")
    parts = [data_sharded(mesh, getattr(batch, f)) for f in fields]
    return [type(batch)(*shard) for shard in zip(*parts)]


def gather_shards(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``parts`` (one per shard) moved to ``device`` and concatenated along
    their leading axis in shard order."""
    return torch.cat([p.to(device) for p in parts])


def reduce_shards(parts: Sequence[torch.Tensor], device: torch.device, op: str = "sum"):
    """The cross-shard reduction of the port's sharded paths: ``parts`` (one
    per shard) moved to ``device`` and combined in shard order, ``op`` being
    ``"sum"`` or ``"max"``.  No atomics and no collective library: the
    order is fixed, so the result is the same on every run."""
    total = parts[0].to(device)
    for p in parts[1:]:
        p = p.to(device)
        total = total + p if op == "sum" else torch.maximum(total, p)
    return total
