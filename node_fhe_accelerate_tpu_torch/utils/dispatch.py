"""Adaptive backend dispatch: measure once, then route (counterpart of
node_fhe_accelerate_tpu/utils/dispatch.py).

The dispatcher measures the implementations registered for an op once per
(op, shape class) on the live device, caches the winner, and routes every
later call with that shape class to it.  A candidate that raises
``Unsupported`` (before any launch: it cannot take these inputs) loses the
race with time ``inf``; any other exception propagates, so a kernel that
fails to build or launch stops the race instead of handing it to a slower
candidate.  A winner that raises ``Unsupported`` on a later call of its
shape class (a new key whose prepared form no longer fits) hands that call
to the race's next fastest candidate that takes it; the shape class keeps
its winner and no new race runs.

Call sites:

* ``TfheEngine(ext_backend="auto")`` on the card routes
  ``bootstrap_with_test_poly`` through a dispatcher over the "pallas"
  (per-step kernel), "mxu" (plain contraction), "pallas_fused" and
  "mxu_fused" (one-launch ladders) backends (core/bootstrap.py);
* ``Curve.msm`` (zk/curve.py) races the Pippenger against the per-point
  ladders inside the band 32 <= n_pad <= 1024, through
  ``global_dispatcher()``.

Every timed call ends in ``torch.cuda.synchronize()`` when its output lies
on the card, and each timed iteration perturbs the first integer tensor of
the arguments (XOR with the iteration index; the values are discarded,
only the winner matters), as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["AdaptiveDispatcher", "Candidate", "Unsupported",
           "global_dispatcher"]

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8)


class Unsupported(Exception):
    """Raised by a candidate, before it launches anything, for inputs it
    cannot take; the candidate then loses the race with time ``inf``."""


@dataclass
class Candidate:
    name: str
    fn: Callable


@dataclass
class _Selection:
    name: str
    fn: Callable
    timings: dict


def _children(x):
    """The sub-values a walk descends into: the items of a tuple or list,
    the fields of a dataclass instance (None fields hold nothing)."""
    if isinstance(x, (tuple, list)):
        return list(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [getattr(x, f.name) for f in dataclasses.fields(x)
                if getattr(x, f.name) is not None]
    return None


def _leaves(x):
    kids = _children(x)
    if kids is None:
        return [x]
    return [leaf for k in kids for leaf in _leaves(k)]


def _force(out) -> None:
    """Wait for the card when any tensor of ``out`` lies on it."""
    for leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


def _xor_first_int(x, i: int):
    """(x with its first integer tensor XOR i, whether one was found)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in _INT_DTYPES:
            return x ^ i, True
        return x, False
    if isinstance(x, (tuple, list)):
        out = list(x)
        for k, v in enumerate(out):
            out[k], done = _xor_first_int(v, i)
            if done:
                return type(x)(out), True
        return x, False
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if v is None:
                continue
            new, done = _xor_first_int(v, i)
            if done:
                return dataclasses.replace(x, **{f.name: new}), True
    return x, False


def _perturb(args, i: int):
    """Vary the first integer tensor by the iteration index so repeated
    timing calls are not literally identical."""
    if i == 0:
        return args
    return _xor_first_int(tuple(args), i)[0]


class AdaptiveDispatcher:
    """Measure-once-per-shape-class dispatch."""

    def __init__(self, warmup: int = 1, iters: int = 3):
        self._candidates: dict[str, list[Candidate]] = {}
        self._cache: dict[tuple, _Selection] = {}
        self.warmup = warmup
        self.iters = iters

    def register(self, op: str, name: str, fn: Callable):
        self._candidates.setdefault(op, []).append(Candidate(name, fn))

    def has(self, op: str) -> bool:
        """Whether any candidate is registered for ``op``."""
        return op in self._candidates

    def _shape_class(self, args) -> tuple:
        out = []
        for leaf in _leaves(tuple(args)):
            if isinstance(leaf, torch.Tensor):
                out.append(tuple(leaf.shape) + (str(leaf.dtype),))
            else:
                out.append(type(leaf).__name__)
        return tuple(out)

    def _selection(self, op: str, args) -> _Selection:
        cands = self._candidates.get(op)
        if not cands:
            raise KeyError(f"no candidates registered for {op!r}")
        key = (op, self._shape_class(args))
        sel = self._cache.get(key)
        if sel is None:
            sel = self._cache[key] = self._select(cands, args)
        return sel

    def dispatch(self, op: str, *args):
        sel = self._selection(op, args)
        try:
            return sel.fn(*args)
        except Unsupported:
            pass
        fns = {c.name: c.fn for c in self._candidates[op]}
        for name in sorted(sel.timings, key=sel.timings.get):
            if name == sel.name:
                continue
            try:
                return fns[name](*args)
            except Unsupported:
                pass
        raise Unsupported(f"no candidate of {op!r} takes this call")

    def winners(self, op: str) -> set:
        """The names that won a race of ``op``, over its shape classes."""
        return {sel.name for (o, _), sel in self._cache.items() if o == op}

    def selection_for(self, op: str, *args) -> str:
        """Winner name for these args (measuring on first use)."""
        return self._selection(op, args).name

    def _select(self, cands, args) -> _Selection:
        timings = {}
        best = None
        for cand in cands:
            try:
                for _ in range(self.warmup):
                    out = cand.fn(*args)
                _force(out)
                t0 = time.perf_counter()
                for i in range(self.iters):
                    out = cand.fn(*_perturb(args, i))
                    _force(out)
                dt = (time.perf_counter() - t0) / self.iters
                timings[cand.name] = dt
                if best is None or dt < timings[best.name]:
                    best = cand
            except Unsupported:
                timings[cand.name] = float("inf")
        if best is None:
            raise RuntimeError("no dispatch candidate succeeded")
        return _Selection(name=best.name, fn=best.fn, timings=timings)

    def selection_table(self) -> dict:
        """(op, shape class) -> winner + seconds per call of each
        candidate."""
        return {k: {"winner": v.name, "timings": dict(v.timings)}
                for k, v in self._cache.items()}


_GLOBAL: AdaptiveDispatcher | None = None


def global_dispatcher() -> AdaptiveDispatcher:
    """Process-wide dispatcher shared by the call sites."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = AdaptiveDispatcher()
    return _GLOBAL
