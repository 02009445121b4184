"""One TFHE blind-rotate CMux step, as a hand-written CUDA kernel for
Hopper and its plain PyTorch version (counterpart of the ``cmux_step_pallas``
/ ``cmux_step_tiles`` entries of node_fhe_accelerate_tpu/ops/pallas_cmux.py,
whose body is ``_cmux_kernel_v1``).

    out = acc + sum_p 256^p * (digits(X^rot * acc - acc) x Toeplitz(g~_p))

``cmux_step`` launches ``csrc/cmux_step.cu`` for a CUDA tensor and takes
the plain version only for a CPU tensor.  The kernel is built with ``nvcc``
at first use into ``build/kernels/`` beside the package (listed in
.gitignore) and bound through ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..core.torus import TorusRing
from .i8 import i8_digit_planes_to_u32, negacyclic_toeplitz_idx

__all__ = ["cmux_step", "cmux_step_reference", "external_product_plain",
           "build", "build_info"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "cmux_step.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_lib = None
build_info: dict = {"seconds": None, "log": ""}


def _contract_i8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) @ int8 (K, N) -> int32.  On the CPU through
    ``torch._int_mm``; on the card as float64, exact because the callers'
    int32 accumulation bound keeps every |sum| below 2^31 < 2^53."""
    if x.device.type == "cpu":
        return torch._int_mm(x.contiguous(), w.contiguous())
    return torch.matmul(x.to(torch.float64),
                        w.to(torch.float64)).to(torch.int32)


def external_product_plain(ggsw_i8_row: torch.Tensor, glwe_data: torch.Tensor,
                           base_log: int, drop: int = 0) -> torch.Tensor:
    """GGSW (x) GLWE as one exact int8 contraction (the algebra of the
    reference's ``external_product_mxu``).

    ggsw_i8_row: int8 (lvl, k+1, k+1, P, 2N) digit planes of g~ = [g, -g];
    glwe_data: int32 (..., k+1, N).  Plane p carries weight 256^(p+drop).
    """
    lvl, kp1, _, planes, two_n = ggsw_i8_row.shape
    n = two_n // 2
    digits = TorusRing(n).decompose(glwe_data, base_log, lvl)
    d = torch.movedim(digits, 0, -3).to(torch.int8)      # (..., lvl, k+1, N)
    batch = d.shape[:-3]
    d = d.reshape(-1, lvl * kp1 * n)
    idx = torch.as_tensor(negacyclic_toeplitz_idx(n), dtype=torch.long,
                          device=ggsw_i8_row.device)
    t = ggsw_i8_row[..., idx]                 # (lvl, j, jp, P, c, r)
    w = t.permute(0, 1, 4, 2, 3, 5).reshape(lvl * kp1 * n, kp1 * planes * n)
    out = _contract_i8(d, w).reshape(-1, kp1, planes, n)
    res = i8_digit_planes_to_u32(torch.movedim(out, 2, -1))
    if drop:
        res = res * (1 << (8 * drop))
    return res.reshape(batch + (kp1, n))


def cmux_step_reference(acc: torch.Tensor, rot: torch.Tensor,
                        ggsw_i8_row: torch.Tensor, base_log: int
                        ) -> torch.Tensor:
    """Plain PyTorch CMux step: rotate, difference, decompose, Toeplitz
    contraction, plane recombination.  acc int32 (B, k+1, N), rot int32
    (B,), ggsw_i8_row int8 (lvl, k+1, k+1, P, 2N)."""
    rotated = TorusRing(acc.shape[-1]).rotate(acc, rot[:, None])
    return acc + external_product_plain(ggsw_i8_row, rotated - acc, base_log)


def _check(acc, rot, g, base_log):
    if acc.dtype != torch.int32 or acc.dim() != 3 or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous int32 (B, k+1, N) tensor")
    b, kp1, n = acc.shape
    if rot.dtype != torch.int32 or tuple(rot.shape) != (b,) \
            or not rot.is_contiguous():
        raise ValueError(f"rot must be a contiguous int32 ({b},) tensor")
    if g.dtype != torch.int8 or g.dim() != 5 or not g.is_contiguous():
        raise ValueError("ggsw_i8_row must be a contiguous int8 "
                         "(lvl, k+1, k+1, P, 2N) tensor")
    lvl, gk1, gk2, planes, two_n = g.shape
    if (gk1, gk2, two_n) != (kp1, kp1, 2 * n):
        raise ValueError(f"ggsw_i8_row shape {tuple(g.shape)} does not fit "
                         f"acc shape {tuple(acc.shape)}")
    if not (acc.device == rot.device == g.device):
        raise ValueError("acc, rot and ggsw_i8_row must share one device")
    if n < 32 or n & (n - 1):
        raise ValueError(f"N={n} must be a power of two >= 32")
    if not 1 <= planes <= 4:
        raise ValueError(f"{planes} digit planes; 1..4 supported")
    if not 1 <= base_log <= 8 or lvl * base_log > 32:
        raise ValueError(f"base_log={base_log}, level={lvl}: digits must "
                         "fit int8 and level*base_log <= 32")
    # int32 accumulation bound (TfheEngine): terms * (base/2) * 128 < 2^31
    if lvl * kp1 * n * (1 << (base_log - 1)) * 128 >= (1 << 31):
        raise ValueError("shape exceeds the exact int32 accumulation bound")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def build():
    """Compile csrc/cmux_step.cu for sm_90a (once per source content) and
    load it; returns the ctypes library."""
    global _lib
    if _lib is not None:
        return _lib
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"cmux_step_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        build_info.update(seconds=time.perf_counter() - t0,
                          log=proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    lib.nfa_cmux_step.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.nfa_cmux_step.restype = ctypes.c_int
    _lib = lib
    return lib


def cmux_step(acc: torch.Tensor, rot: torch.Tensor, ggsw_i8_row: torch.Tensor,
              base_log: int) -> torch.Tensor:
    """acc + GGSW (x) (X^rot acc - acc) for one LWE key bit.

    acc int32 (B, k+1, N) torus bits; rot int32 (B,), any value (reduced
    mod 2N); ggsw_i8_row int8 (lvl, k+1, k+1, P, 2N), one step's row of
    BootstrapKey.ggsw_i8.  A CUDA tensor launches the Hopper kernel (and
    counts it in ``cmux_step.launches``); a CPU tensor takes the plain
    version."""
    _check(acc, rot, ggsw_i8_row, base_log)
    if acc.device.type == "cpu":
        return cmux_step_reference(acc, rot, ggsw_i8_row, base_log)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    lib = build()
    out = torch.empty_like(acc)
    b, kp1, n = acc.shape
    lvl, _, _, planes, _ = ggsw_i8_row.shape
    if b == 0:
        return out
    with torch.cuda.device(acc.device):
        err = lib.nfa_cmux_step(
            acc.data_ptr(), rot.data_ptr(), ggsw_i8_row.data_ptr(),
            out.data_ptr(), b, kp1, lvl, planes, n, base_log,
            torch.cuda.current_stream(acc.device).cuda_stream)
    if err:
        raise RuntimeError(f"cmux_step kernel launch failed: CUDA error "
                           f"{err}")
    cmux_step.launches += 1
    return out


cmux_step.launches = 0
