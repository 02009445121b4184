"""Profiling, tracing and memory utilities (counterpart of
node_fhe_accelerate_tpu/utils/profiling.py).

* ``trace(path)``: a context manager around ``torch.profiler`` with CPU and
  (on a machine with a card) CUDA activity, exported as a Chrome trace
  (Perfetto, chrome://tracing) into the directory ``path``;
* ``device_memory_stats()``: the CUDA caching allocator's statistics per
  card;
* ``Timer``: a scoped timer, and ``Timer.time_blocked`` that waits for the
  output's card;
* ``live_array_bytes()``: the bytes of live tensors on the cards (leak
  hunting).
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

from .dispatch import _leaves

__all__ = ["trace", "device_memory_stats", "Timer", "live_array_bytes",
           "block_until_ready"]


@dataclass
class TraceFile:
    """Where ``trace`` wrote its Chrome trace (set when the block ends)."""
    path: str = ""


@contextlib.contextmanager
def trace(path: str):
    """Profile the block (CPU and, with a card, CUDA activity) and write
    ``<path>/trace.json``, a Chrome trace; yields a ``TraceFile`` whose
    ``path`` names the file once the block ends."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    out = TraceFile()
    with profile(activities=acts) as prof:
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out.path = os.path.join(path, "trace.json")
    prof.export_chrome_trace(out.path)


def device_memory_stats() -> list:
    """Per-card allocator statistics (``torch.cuda.memory_stats``:
    allocated/reserved bytes, peaks, allocation counts); an empty list
    without a card."""
    return [{"device": f"cuda:{i}", "stats": torch.cuda.memory_stats(i)}
            for i in range(torch.cuda.device_count())]


def live_array_bytes() -> int:
    """Bytes of live tensors on the cards, as the caching allocator counts
    them (``torch.cuda.memory_allocated``, summed over the cards).  On a
    machine without a card this is 0: the allocator keeps no count of CPU
    tensors."""
    return sum(torch.cuda.memory_allocated(i)
               for i in range(torch.cuda.device_count()))


def block_until_ready(out) -> None:
    """Wait for every card that holds a tensor of ``out`` (tensors, tuples,
    lists, dataclasses such as a sharded ciphertext's slices)."""
    cards = {leaf.device for leaf in _leaves(out)
             if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in cards:
        torch.cuda.synchronize(dev)


@dataclass
class Timer:
    """Scoped timer; ``time_blocked`` waits for the card."""
    label: str = ""
    elapsed_s: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self._t0
        return False

    @staticmethod
    def time_blocked(thunk, iters: int = 1) -> float:
        """Seconds per call of ``thunk`` over ``iters`` calls after one
        warm-up call, each run closed by a synchronize of the cards its
        output lies on (none for CPU outputs)."""
        out = thunk()
        block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = thunk()
        block_until_ready(out)
        return (time.perf_counter() - t0) / iters
