"""Cross-position collectives on per-position values (counterpart of
node_fhe_accelerate_tpu/parallel/collectives.py).

Under JAX's ``shard_map`` a collective is a call inside the per-shard body
(``lax.ppermute``, ``lax.all_to_all``); in the port's single-controller
mesh (``mesh.py``) it is a function over the list of per-position values,
one entry per mesh position in position order.  A value is a tensor or a
tuple of tensors (limb planes), and each lies on its position's device.

Every copy between positions is ``Tensor.to(dst, non_blocking=True)``,
which goes peer to peer between distinct cards and is a no-op between
positions on one device.  ``traffic`` counts the bytes and the values that
move between *distinct mesh positions* -- whether or not the positions
share a device -- and never a position's own share: the port's yardstick
for what a collective moves (the JAX package reads its figure from the
compiled program's collectives, which include a device's own slice).

Modular reductions across positions use recursive doubling with
``ppermute`` and the limb-plane modular add, as the JAX package does:
``jax.lax.psum`` on uint32 lanes would drop the carry chain.
"""
from __future__ import annotations

import torch

from .mesh import to_device

__all__ = ["traffic", "ppermute", "all_to_all", "gather_to", "psum_mod",
           "allreduce_mod_tree"]


class _Traffic:
    """Bytes and values moved between distinct positions since the last
    ``reset``."""

    def __init__(self):
        self.bytes = 0
        self.values = 0

    def reset(self) -> None:
        self.bytes = 0
        self.values = 0

    def add(self, value) -> None:
        self.values += 1
        self.bytes += sum(t.numel() * t.element_size()
                          for t in _tensors(value))


traffic = _Traffic()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _tensors(v)]


def _device_of(x) -> torch.device:
    return _tensors(x)[0].device


def _send(value, src: int, dst: int, device):
    """``value`` of position ``src`` delivered to position ``dst``."""
    if src != dst:
        traffic.add(value)
    return to_device(value, device)


def _map(fn, x, *rest):
    """``fn`` over a tensor, or over the matching tensors of tuples."""
    if isinstance(x, torch.Tensor):
        return fn(x, *rest)
    return tuple(_map(fn, *parts) for parts in zip(x, *rest))


def ppermute(shards: list, perm) -> list:
    """``lax.ppermute``: position ``dst`` receives the value of ``src`` for
    each pair (src, dst) of ``perm``; a position that receives nothing gets
    zeros of its own value's shape."""
    out = [None] * len(shards)
    for src, dst in perm:
        out[dst] = _send(shards[src], src, dst, _device_of(shards[dst]))
    return [o if o is not None else _map(torch.zeros_like, s)
            for o, s in zip(out, shards)]


def all_to_all(shards: list, split_dim: int, concat_dim: int) -> list:
    """``lax.all_to_all(..., tiled=False)``: each position's value has size
    P (the position count) along ``split_dim``; position d receives entry
    d of every position's value, and stacks them, by source position, along
    a new axis at ``concat_dim`` of its result (whose rank is the input's,
    the split axis removed)."""
    P = len(shards)
    out = []
    for d in range(P):
        dev = _device_of(shards[d])
        parts = [_send(_map(lambda t: t.select(split_dim % t.dim(), d),
                            shards[s]), s, d, dev) for s in range(P)]
        # the result has the input's rank: the stacked axis lands at
        # concat_dim of a tensor one dimension larger than each part
        out.append(_map(lambda *ts: torch.stack(
            ts, dim=concat_dim % (ts[0].dim() + 1)), *parts))
    return out


def gather_to(shards: list, dst: int = 0) -> list:
    """Every position's value delivered to position ``dst`` (in position
    order), as the combine of a sharded reduction reads them."""
    dev = _device_of(shards[dst])
    return [_send(v, s, dst, dev) for s, v in enumerate(shards)]


def psum_mod(ctx, shards: list) -> list:
    """All-reduce modular sum of (lo, hi) planes over the positions.

    Recursive doubling: after step s every position holds the sum of its
    2^(s+1)-neighbourhood; after log2(P) steps, the full modular sum (the
    same bits on every position).  Needs a power-of-two position count."""
    n = len(shards)
    if n & (n - 1):
        raise ValueError(f"psum_mod needs a power-of-two axis, got {n}")
    acc = [tuple(s) for s in shards]
    span = 1
    while span < n:
        # each position swaps running sums with its partner at `span`
        perm = [(i, i + span if (i // span) % 2 == 0 else i - span)
                for i in range(n)]
        other = ppermute(acc, perm)
        acc = [ctx.add(a, o) for a, o in zip(acc, other)]
        span *= 2
    return acc


def allreduce_mod_tree(ctx, shards: list) -> list:
    """Alias with the reference's tree-reduce name (encryption.h:308)."""
    return psum_mod(ctx, shards)
