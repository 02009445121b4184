"""Kernel timing on the card by CUDA events, for ``chip_smoke.py`` and the
scripts under ``scripts/``.

``cuda_ms`` times calls as the host issues them: a call whose host work
outlasts its kernels reads the host's time.  ``device_ms`` holds the stream
behind a spin kernel while the host enqueues the calls, so its events time
the kernels back to back; it also returns the host's time per call.
"""
from __future__ import annotations

import functools
import subprocess
import time

import torch

__all__ = ["max_sm_mhz", "cuda_ms", "device_ms"]


@functools.cache
def max_sm_mhz() -> float:
    """The card's highest SM clock in MHz, as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """ms per call of ``fn`` between two events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2, spin_ms: float = 20.0):
    """(device ms, host ms) per call: as ``cuda_ms``, but a spin kernel of
    ``spin_ms`` at the top clock holds the stream while the host enqueues
    the calls, so the events time the kernels back to back and not the
    host's work between them.  Raises if the spin ended before the last
    call was enqueued."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(spin_ms * max_sm_mhz() * 1e3))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    hidden = not start.query()
    end.record()
    torch.cuda.synchronize()
    if not hidden:
        raise RuntimeError("device_ms: the spin ended before the calls "
                           "were enqueued; the time would include the host")
    return start.elapsed_time(end) / iters, host_ms
