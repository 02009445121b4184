"""The whole TFHE blind-rotate ladder in one kernel launch: hand-written
CUDA kernels for Hopper and their plain PyTorch versions (counterpart of
``blind_rotate_fused`` and ``blind_rotate_fused_steps`` of
node_fhe_accelerate_tpu/ops/pallas_cmux.py).

For every step s, in order,

    acc <- acc + sum_p 256^(p+drop) *
                 (digits(X^rot[s] * acc - acc) x Toeplitz(g~[s]_p))

* ``blind_rotate_fused`` (batch tile outer) reads the bootstrap key's int8
  planes as stored and launches ``csrc/ladder_tiles.cu``;
* ``blind_rotate_fused_steps`` (steps outer) reads the K-major slabs of
  ``build_all_step_kslabs`` and launches ``csrc/ladder_steps.cu``.

A CUDA tensor launches the kernel (built at first use, see ``_build.py``)
or raises; only a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary
from .cmux import (BLOCK, batch_chunks, check_acc_rot, check_gadget,
                   check_weights, cmux_step_reference, contract_i8,
                   digit_scratch, launch, recombine_planes, step_digits)

__all__ = ["blind_rotate_fused", "blind_rotate_fused_reference",
           "blind_rotate_fused_steps", "blind_rotate_fused_steps_reference",
           "TILES_LIB", "STEPS_LIB"]

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
TILES_LIB = KernelLibrary(
    "ladder_tiles.cu", {"nfa_ladder_tiles": [_PTR] * 6 + [_INT] * 7 + [_PTR]})
STEPS_LIB = KernelLibrary(
    "ladder_steps.cu", {"nfa_ladder_steps": [_PTR] * 6 + [_INT] * 8 + [_PTR]})


def _flatten(acc: torch.Tensor, a_rots: torch.Tensor, n_steps: int):
    """acc (..., k+1, N) -> (B, k+1, N) contiguous; a_rots (n_steps, ...)
    -> (n_steps, B) contiguous int32."""
    if acc.dim() < 2:
        raise ValueError("acc must be (..., k+1, N)")
    lead = acc.shape[:-2]
    flat = acc.reshape((-1,) + tuple(acc.shape[-2:])).contiguous()
    rots = torch.as_tensor(a_rots, device=acc.device)
    want = (n_steps,) + tuple(lead)
    if rots.dtype != torch.int32 or tuple(rots.shape) != want:
        raise ValueError(f"a_rots must be an int32 {want} tensor, got "
                         f"{rots.dtype} {tuple(rots.shape)}")
    rots = rots.reshape(n_steps, flat.shape[0]).contiguous()
    check_acc_rot(flat, rots, (n_steps, flat.shape[0]))
    return flat, rots


def blind_rotate_fused_reference(acc: torch.Tensor, a_rots: torch.Tensor,
                                 ggsw_i8: torch.Tensor, base_log: int
                                 ) -> torch.Tensor:
    """Plain PyTorch ladder against the key rows it is given: one
    ``cmux_step_reference`` per row.  acc int32 (B, k+1, N), a_rots int32
    (n_steps, B), ggsw_i8 int8 (n_steps, lvl, k+1, k+1, P, 2N)."""
    for s in range(ggsw_i8.shape[0]):
        acc = cmux_step_reference(acc, a_rots[s], ggsw_i8[s], base_log)
    return acc


def blind_rotate_fused_steps_reference(acc: torch.Tensor,
                                       a_rots: torch.Tensor,
                                       kslabs: torch.Tensor, base_log: int,
                                       drop: int = 0) -> torch.Tensor:
    """Plain PyTorch ladder against the K-major slabs it is given (so a
    wrong layout shows): per step, digits (B, (l, j, c)) @ kslabs[s]^T,
    its columns (jp, block, q, p, w) put back in (jp, p, coefficient)
    order.  acc int32 (B, k+1, N), a_rots int32 (n_steps, B), kslabs int8
    (n_steps, (k+1)*P*N, lvl*(k+1)*N)."""
    b, kp1, n = acc.shape
    n_steps, cols, kdim = kslabs.shape
    lvl, planes = kdim // (kp1 * n), cols // (kp1 * n)
    for s in range(n_steps):
        x = step_digits(acc, a_rots[s], base_log, lvl).reshape(b, kdim)
        y = contract_i8(x, kslabs[s].t())
        y = y.reshape(b, kp1, n // 64, 8, planes, 8).permute(0, 1, 4, 2, 3, 5)
        acc = acc + recombine_planes(y.reshape(b, kp1, planes, n), drop)
    return acc


def blind_rotate_fused(acc: torch.Tensor, a_rots: torch.Tensor,
                       ggsw_i8: torch.Tensor, base_log: int) -> torch.Tensor:
    """All blind-rotate CMux steps in one launch, batch tile outer.

    acc int32 (..., k+1, N), the X^{-b~}-rotated accumulator; a_rots int32
    (n_steps, ...) rotation amounts per step; ggsw_i8 int8
    (n_steps, lvl, k+1, k+1, P, 2N), BootstrapKey.ggsw_i8 as stored.  A
    CUDA tensor launches the Hopper kernel once per range of
    ``batch_chunks`` (counted in ``blind_rotate_fused.launches``; it needs
    N % 128 == 0); a CPU tensor takes the plain version.  An empty
    batch returns an empty tensor and launches nothing."""
    if ggsw_i8.dim() != 6:
        raise ValueError("ggsw_i8 must be (n_steps, lvl, k+1, k+1, P, 2N)")
    n_steps, lvl, _, _, planes, _ = ggsw_i8.shape
    flat, rots = _flatten(acc, a_rots, n_steps)
    b, kp1, n = flat.shape
    check_weights(ggsw_i8, (n_steps, lvl, kp1, kp1, planes, 2 * n),
                  "ggsw_i8", flat)
    check_gadget(kp1, n, lvl, planes, base_log)
    if b == 0:
        return torch.empty_like(acc)
    if flat.device.type == "cpu":
        return blind_rotate_fused_reference(flat, rots, ggsw_i8,
                                            base_log).reshape(acc.shape)
    if n % BLOCK:
        raise ValueError(f"N={n}: the kernel needs N % {BLOCK} == 0")
    out = torch.empty_like(flat)
    kdim = lvl * kp1 * n
    chunks = batch_chunks(b, kdim)
    dig = digit_scratch(chunks[0][1], kdim, flat.device)
    for start, stop in chunks:
        part = rots[:, start:stop].contiguous()   # no copy for one chunk
        counter = torch.zeros(1, dtype=torch.int32, device=flat.device)
        launch(TILES_LIB.load().nfa_ladder_tiles, "ladder_tiles",
               flat.device, flat[start].data_ptr(), part.data_ptr(),
               ggsw_i8.data_ptr(), out[start].data_ptr(), dig.data_ptr(),
               counter.data_ptr(), stop - start, kp1, lvl, planes, n,
               base_log, n_steps)
        blind_rotate_fused.launches += 1
    return out.reshape(acc.shape)


blind_rotate_fused.launches = 0


def blind_rotate_fused_steps(acc: torch.Tensor, a_rots: torch.Tensor,
                             slabs: torch.Tensor, base_log: int,
                             drop: int = 0) -> torch.Tensor:
    """All blind-rotate CMux steps in one launch, steps outer.

    acc int32 (..., k+1, N); a_rots int32 (n_steps, ...); slabs int8
    (n_steps, (k+1)*P*N, lvl*(k+1)*N), the K-major form of
    ``build_all_step_kslabs`` (``TfheEngine.prepare_bsk(form="slabs")``);
    ``drop`` is TfheParams.bsk_drop_planes: plane p weighs 256^(p+drop).  A
    CUDA tensor launches the Hopper kernel once per range of
    ``batch_chunks``, i.e. once below ~838k rows at TFHE_BOOT_128_K4
    (counted in ``blind_rotate_fused_steps.launches``); a CPU tensor takes
    the plain version.  An empty batch returns an empty tensor and launches
    nothing."""
    if acc.dim() < 2 or slabs.dim() != 3:
        raise ValueError("acc must be (..., k+1, N) and slabs "
                         "(n_steps, (k+1)*P*N, lvl*(k+1)*N)")
    kp1, n = acc.shape[-2:]
    n_steps, cols, kdim = slabs.shape
    if n % BLOCK or kdim % (kp1 * n) or cols % (kp1 * n):
        raise ValueError(f"slabs shape {tuple(slabs.shape)} does not fit "
                         f"acc shape {tuple(acc.shape)}")
    lvl, planes = kdim // (kp1 * n), cols // (kp1 * n)
    flat, rots = _flatten(acc, a_rots, n_steps)
    b = flat.shape[0]
    check_weights(slabs, (n_steps, kp1 * planes * n, lvl * kp1 * n),
                  "slabs", flat)
    check_gadget(kp1, n, lvl, planes, base_log, drop)
    if b == 0:
        return torch.empty_like(acc)
    if flat.device.type == "cpu":
        return blind_rotate_fused_steps_reference(
            flat, rots, slabs, base_log, drop).reshape(acc.shape)
    out = torch.empty_like(flat)
    chunks = batch_chunks(b, kdim)
    dig = digit_scratch(chunks[0][1], kdim, flat.device)
    for start, stop in chunks:
        part = rots[:, start:stop].contiguous()   # no copy for one chunk
        counter = torch.zeros(1, dtype=torch.int32, device=flat.device)
        launch(STEPS_LIB.load().nfa_ladder_steps, "ladder_steps",
               flat.device, flat[start].data_ptr(), part.data_ptr(),
               slabs.data_ptr(), out[start].data_ptr(), dig.data_ptr(),
               counter.data_ptr(), stop - start, kp1, lvl, planes, n,
               base_log, drop, n_steps)
        blind_rotate_fused_steps.launches += 1
    return out.reshape(acc.shape)


blind_rotate_fused_steps.launches = 0
