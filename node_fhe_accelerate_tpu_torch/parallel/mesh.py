"""Device mesh for multi-device FHE/ZK pipelines (counterpart of
node_fhe_accelerate_tpu/parallel/mesh.py).

The JAX package's parallel layer is single-controller: one process owns a
``Mesh`` of devices and ``shard_map`` runs a per-shard body on each.  The
port keeps that contract with plain PyTorch: a ``Mesh`` is an array of
``torch.device`` of shape (data, model) under the axis names
``("data", "model")``, a ``Sharded`` value holds one tensor per mesh
position, and the per-shard bodies are plain functions the caller maps over
the positions (the collectives between them are in ``collectives.py``).

    "data"  -- ciphertext/ballot batch sharding (the dominant FHE axis)
    "model" -- intra-op sharding (large-N NTT stage groups, MSM buckets)

A sharded layout always splits over the positions of one axis (the
devices along it at index 0 of the other axis), and a replicated value is
copied once per *distinct* device, not once per position.  By default a
mesh spans the visible CUDA devices, one position each; a device may stand
at more than one position only when the caller lists it in ``devices=``
(four positions on one card, or on the CPU in the tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "NamedSharding", "Sharded", "Replicated", "make_mesh",
           "data_sharding", "replicated", "put", "shard", "replicate",
           "gather", "to_device", "canonical_device"]


def canonical_device(device) -> torch.device:
    """``device`` with its index: plain "cuda" names the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An array of ``torch.device`` of shape (data, model) with named
    axes; ``mesh.shape[axis]`` is the axis size, as in JAX."""

    def __init__(self, devices, axis_names=("data", "model")):
        given = np.asarray(devices, dtype=object)
        devs = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = canonical_device(given[idx])
        if devs.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devs.shape} do not match "
                             f"the axis names {axis_names}")
        self.devices = devs
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devs.shape))

    def axis_devices(self, axis: str = "data") -> list:
        """The devices of the positions along ``axis`` (index 0 of the
        other axes), in position order."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out

    def distinct_devices(self) -> list:
        """Each device of the mesh once, in first-position order."""
        seen = {}
        for d in self.devices.reshape(-1):
            seen.setdefault(str(d), d)
        return list(seen.values())

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int = 1, devices=None) -> Mesh:
    """Mesh of shape (data, model) over the first data*model devices.

    ``devices`` defaults to the visible CUDA devices; a mesh with more
    positions than those raises (as the JAX one does at its reshape).  Pass
    ``devices=`` to list the devices yourself, one per position, repeats
    allowed (e.g. ``[torch.device("cuda:0")] * 4``)."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [canonical_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devs)
    if data is None:
        data = n_devices // model
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}) needs at least one "
                         "position on each axis")
    if data * model > len(devs):
        raise ValueError(
            f"a mesh of {data} x {model} positions needs {data * model} "
            f"devices, {len(devs)} given"
            + ("" if devices is not None else
               " (the visible CUDA devices); list the devices in devices= "
               "to place several positions on one"))
    use = np.empty(data * model, dtype=object)
    use[:] = devs[: data * model]
    return Mesh(use.reshape(data, model), ("data", "model"))


@dataclass(frozen=True)
class NamedSharding:
    """A layout over a mesh: ``spec`` names, per dimension, the mesh axis
    it is split over (None: not split); an empty spec is replicated."""
    mesh: Mesh
    spec: tuple


def data_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0
                  ) -> NamedSharding:
    """Shard one batch axis over "data", replicate the rest."""
    spec = [None] * ndim
    spec[batch_axis] = "data"
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


@dataclass
class Sharded:
    """One tensor per position of ``axis``, each the slice of the global
    value along ``dim`` that the position holds, on its device."""
    shards: list
    mesh: Mesh
    dim: int
    global_shape: tuple
    axis: str = "data"


@dataclass
class Replicated:
    """The same value on every distinct device of a mesh (one copy each)."""
    copies: dict
    mesh: Mesh

    def on(self, device):
        return self.copies[str(canonical_device(device))]


def _leaf_map(fn, x):
    """``fn`` over the tensors of tuples, lists and dataclass instances."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_leaf_map(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _leaf_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def to_device(x, device):
    """``x`` (a tensor, or tuples/lists/dataclasses of them) on ``device``;
    a card-to-card copy does not wait (``non_blocking``), a copy to the CPU
    does."""
    device = canonical_device(device)
    nb = device.type == "cuda"
    return _leaf_map(lambda t: t if t.device == device
                     else t.to(device, non_blocking=nb), x)


def shard(x: torch.Tensor, mesh: Mesh, dim: int = 0,
          axis: str = "data") -> Sharded:
    """Split ``x`` along ``dim`` into equal slices, one per position of
    ``axis``, each moved to its position's device."""
    devs = mesh.axis_devices(axis)
    dim = dim % x.dim()
    if x.shape[dim] % len(devs):
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {len(devs)} positions")
    parts = torch.chunk(x, len(devs), dim=dim)
    return Sharded([to_device(p.contiguous(), d)
                    for p, d in zip(parts, devs)], mesh, dim,
                   tuple(x.shape), axis)


def replicate(x, mesh: Mesh) -> Replicated:
    """``x`` copied once to each distinct device of the mesh; on the device
    it lies on it keeps its tensors (no copy)."""
    return Replicated({str(d): to_device(x, d)
                       for d in mesh.distinct_devices()}, mesh)


def put(x, sharding: NamedSharding):
    """``x`` in the layout ``sharding`` describes (``jax.device_put``)."""
    axes = [(i, a) for i, a in enumerate(sharding.spec) if a is not None]
    if not axes:
        return replicate(x, sharding.mesh)
    if len(axes) > 1:
        raise ValueError("a layout splits one dimension")
    dim, axis = axes[0]
    return shard(x, sharding.mesh, dim, axis)


def gather(x, device=None):
    """The global value of a ``Sharded`` (its slices joined on ``device``,
    by default the first position's), recursing through tuples, lists and
    dataclasses; other values pass through."""
    if isinstance(x, Sharded):
        dev = device if device is not None else \
            x.mesh.axis_devices(x.axis)[0]
        return torch.cat([to_device(s, dev) for s in x.shards], dim=x.dim)
    if isinstance(x, (tuple, list)):
        return type(x)(gather(v, device) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: gather(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x
