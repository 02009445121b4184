"""The TFHE blind-rotate CMux step: hand-written CUDA kernels for Hopper,
their plain PyTorch versions, and the Toeplitz weight expansion (counterpart
of the ``cmux_step_pallas`` / ``cmux_step_tiles`` entries and the
``build_*`` functions of node_fhe_accelerate_tpu/ops/pallas_cmux.py).

    out = acc + sum_p 256^p * (digits(X^rot * acc - acc) x Toeplitz(g~_p))

* ``cmux_step`` reads the bootstrap key's row as stored and launches
  ``csrc/cmux_step.cu`` (the reference's ``_cmux_kernel_v1``);
* ``cmux_step_slabs`` reads the diagonal slabs of ``build_diag_slabs`` and
  launches ``csrc/cmux_step_slabs.cu`` in one of two loop orders (the
  reference's ``_cmux_kernel_v3`` and ``_cmux_kernel`` "v2").

A CUDA tensor launches the kernel (built at first use, see ``_build.py``)
or raises; only a CPU tensor takes the plain version.  The ``build_*``
functions are plain torch on any device, as they are XLA outside every
Pallas body in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.torus import TorusRing
from ._build import KernelLibrary, launch
from .i8 import i8_digit_planes_to_u32, negacyclic_toeplitz_idx

__all__ = ["cmux_step", "cmux_step_reference", "cmux_step_slabs",
           "cmux_step_slabs_reference", "external_product_plain",
           "build_diag_tiles", "build_diag_slabs", "build_rt_slabs",
           "build_all_step_tiles", "build_all_step_slabs",
           "STEP_LIB", "SLABS_LIB"]

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
STEP_LIB = KernelLibrary(
    "cmux_step.cu", {"nfa_cmux_step": [_PTR] * 4 + [_INT] * 6 + [_PTR]})
SLABS_LIB = KernelLibrary(
    "cmux_step_slabs.cu",
    {"nfa_cmux_step_slabs": [_PTR] * 4 + [_INT] * 7 + [_PTR]})
BLOCK = 128      # block-Toeplitz tile edge of the prepared weights


# ---------------------------------------------------------------------------
# Toeplitz weight expansion
# ---------------------------------------------------------------------------

def _diag_index(n: int, device) -> torch.Tensor:
    """idx[rt, ct, c, r] = (128 (rt - ct) + r - c) mod 2N: the position in
    g~ of Toeplitz entry T[128 ct + c, 128 rt + r]."""
    nt = n // BLOCK
    t = torch.arange(nt, device=device)
    e = torch.arange(BLOCK, device=device)
    d = BLOCK * (t[:, None] - t[None, :])                  # (rt, ct)
    return torch.remainder(d[:, :, None, None] + e[None, None, None, :]
                           - e[None, None, :, None], 2 * n)


def _diag_tiles(g: torch.Tensor) -> torch.Tensor:
    """build_diag_tiles on the undoubled planes g (..., 2N)."""
    n = g.shape[-1] // 2
    if n % BLOCK:
        raise ValueError(f"N={n} must be a multiple of {BLOCK}")
    nt = n // BLOCK
    idx = _diag_index(n, g.device)
    # diagonal d = rt - ct, from -(nt-1) (rt=0, ct=nt-1) to nt-1 (ct=0)
    diag = torch.cat([idx[0].flip(0), idx[1:, 0]], dim=0)  # (D, c, r)
    return g[..., diag]


def build_diag_tiles(ghat2: torch.Tensor) -> torch.Tensor:
    """Distinct diagonal Toeplitz blocks of one GGSW row.

    ghat2: int8 (lvl, k+1, k+1, P, 4N), the 2N-periodic digit planes of
    [g, -g] doubled, as the reference takes them.  Returns int8
    (lvl, k+1, k+1, P, 2*nt-1, 128, 128) with, for d = rt - ct (diagonal
    index di = d + nt - 1),

        tiles[..., di, c, r] = ghat2[..., (128*d + r - c) mod 2N]
                             = T[128*ct + c, 128*rt + r].

    The reference builds this by log-doubling rolls; an index gather gives
    the same bytes."""
    return _diag_tiles(ghat2[..., :ghat2.shape[-1] // 2])


def _tiles_to_slabs(tiles: torch.Tensor) -> torch.Tensor:
    lvl, kp1, _, planes, d = tiles.shape[:5]
    slabs = tiles.permute(4, 0, 1, 5, 2, 3, 6)             # (D,l,j,c,jp,P,r)
    return slabs.reshape(d, lvl * kp1 * BLOCK, kp1 * planes * BLOCK)


def build_diag_slabs(ghat2: torch.Tensor) -> torch.Tensor:
    """Diagonal blocks in matmul-slab layout: int8
    (D, lvl*(k+1)*128, (k+1)*P*128), slab di the weight matrix W with
    W[(l, j, c), (jp, p, r)] = tiles[l, j, jp, p, di, c, r], so block-row rt
    of the external product is sum_ct X_ct @ W[rt - ct + nt - 1] with X_ct
    the digits (batch, (l, j, c)) at coefficient block ct."""
    return _tiles_to_slabs(build_diag_tiles(ghat2))


def _rt_slabs(g: torch.Tensor) -> torch.Tensor:
    """build_rt_slabs on the undoubled planes g (lvl, k+1, k+1, P, 2N)."""
    lvl, kp1, _, planes, two_n = g.shape
    n = two_n // 2
    if n % BLOCK:
        raise ValueError(f"N={n} must be a multiple of {BLOCK}")
    t = g[..., _diag_index(n, g.device)]        # (l, j, jp, P, rt, ct, c, r)
    t = t.permute(4, 0, 1, 5, 6, 2, 3, 7)       # (rt, l, j, ct, c, jp, P, r)
    return t.reshape(n // BLOCK, lvl * kp1 * n, kp1 * planes * BLOCK)


def build_rt_slabs(ghat2: torch.Tensor) -> torch.Tensor:
    """rt-major Toeplitz slabs for the steps-outer ladder.

    ghat2: int8 (lvl, k+1, k+1, P, 4N).  Returns int8
    (nt, lvl*(k+1)*N, (k+1)*P*128): slab rt is the weight matrix W_rt with
    W_rt[(l, j, ct*128 + c), (jp, p, r)] = T[128*ct + c, 128*rt + r], the
    diagonal resolved at build time.  The layout is the reference's, column
    axis contiguous; the ladder kernel reads it as it is and transposes
    bytes in registers, so no permuted copy is kept beside it."""
    return _rt_slabs(ghat2[..., :ghat2.shape[-1] // 2])


def _build_per_step(ggsw_i8: torch.Tensor, one) -> torch.Tensor:
    """Stack ``one(row)`` over the steps, one step at a time so the peak is
    the output plus one step."""
    first = one(ggsw_i8[0])
    out = torch.empty((ggsw_i8.shape[0],) + tuple(first.shape),
                      dtype=first.dtype, device=first.device)
    out[0] = first
    for i in range(1, ggsw_i8.shape[0]):
        out[i] = one(ggsw_i8[i])
    return out


def build_all_step_tiles(ggsw_i8: torch.Tensor) -> torch.Tensor:
    """Diagonal tiles for every blind-rotate step: ggsw_i8 int8
    (n_steps, lvl, k+1, k+1, P, 2N) -> int8
    (n_steps, lvl, k+1, k+1, P, 2*nt-1, 128, 128)."""
    return _build_per_step(ggsw_i8, _diag_tiles)


def build_all_step_slabs(ggsw_i8: torch.Tensor) -> torch.Tensor:
    """rt-major slabs for every blind-rotate step: ggsw_i8 int8
    (n_steps, lvl, k+1, k+1, P, 2N) (P may be < 4 for truncated keys) ->
    int8 (n_steps, nt, lvl*(k+1)*N, (k+1)*P*128), the layout
    ``build_rt_slabs`` documents."""
    return _build_per_step(ggsw_i8, _rt_slabs)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def contract_i8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
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
    out = contract_i8(d, w).reshape(-1, kp1, planes, n)
    return recombine_planes(out, drop).reshape(batch + (kp1, n))


def step_digits(acc: torch.Tensor, rot: torch.Tensor, base_log: int,
                lvl: int) -> torch.Tensor:
    """int8 (B, lvl, k+1, N): the balanced gadget digits of
    X^rot * acc - acc."""
    ring = TorusRing(acc.shape[-1])
    diff = ring.rotate(acc, rot[:, None]) - acc
    return torch.movedim(ring.decompose(diff, base_log, lvl), 0, 1) \
        .to(torch.int8)


def recombine_planes(out: torch.Tensor, drop: int = 0) -> torch.Tensor:
    """int32 partial sums (..., P, n) -> uint32 bits (..., n), plane p
    weighted 256^(p+drop) mod 2^32."""
    res = i8_digit_planes_to_u32(torch.movedim(out, -2, -1))
    return res * (1 << (8 * drop)) if drop else res


def cmux_step_reference(acc: torch.Tensor, rot: torch.Tensor,
                        ggsw_i8_row: torch.Tensor, base_log: int
                        ) -> torch.Tensor:
    """Plain PyTorch CMux step: rotate, difference, decompose, Toeplitz
    contraction, plane recombination.  acc int32 (B, k+1, N), rot int32
    (B,), ggsw_i8_row int8 (lvl, k+1, k+1, P, 2N)."""
    rotated = TorusRing(acc.shape[-1]).rotate(acc, rot[:, None])
    return acc + external_product_plain(ggsw_i8_row, rotated - acc, base_log)


def cmux_step_slabs_reference(acc: torch.Tensor, rot: torch.Tensor,
                              slabs: torch.Tensor, base_log: int
                              ) -> torch.Tensor:
    """Plain PyTorch CMux step against the prepared diagonal slabs it is
    given (so a wrong slab layout shows): block-row rt sums
    X_ct @ slabs[rt - ct + nt - 1] over ct.  acc int32 (B, k+1, N), rot
    int32 (B,), slabs int8 (2*nt-1, lvl*(k+1)*128, (k+1)*P*128)."""
    b, kp1, n = acc.shape
    _, kd, wide = slabs.shape
    nt = n // BLOCK
    lvl, planes = kd // (kp1 * BLOCK), wide // (kp1 * BLOCK)
    d = step_digits(acc, rot, base_log, lvl).reshape(b, lvl * kp1, nt, BLOCK)
    blocks = []
    for rt in range(nt):
        a32 = torch.zeros((b, wide), dtype=torch.int32, device=acc.device)
        for ct in range(nt):
            a32 += contract_i8(d[:, :, ct].reshape(b, kd),
                               slabs[rt - ct + nt - 1])
        blocks.append(a32.reshape(b, kp1, planes, BLOCK))
    return acc + recombine_planes(torch.cat(blocks, dim=-1))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def check_acc_rot(acc: torch.Tensor, rot: torch.Tensor, rot_shape) -> None:
    if acc.dtype != torch.int32 or acc.dim() != 3 or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous int32 (B, k+1, N) tensor")
    if rot.dtype != torch.int32 or tuple(rot.shape) != tuple(rot_shape) \
            or not rot.is_contiguous():
        raise ValueError(f"rotations must be a contiguous int32 "
                         f"{tuple(rot_shape)} tensor")
    if acc.device.type not in ("cpu", "cuda") or rot.device != acc.device:
        raise ValueError(f"acc on {acc.device} and rotations on "
                         f"{rot.device}: one cpu or cuda device needed")


def check_weights(w: torch.Tensor, shape, name: str, acc: torch.Tensor
                  ) -> None:
    if w.dtype != torch.int8 or tuple(w.shape) != tuple(shape) \
            or not w.is_contiguous() or w.data_ptr() % 4:
        raise ValueError(f"{name} must be a contiguous, 4-byte aligned int8 "
                         f"{tuple(shape)} tensor, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if w.device != acc.device:
        raise ValueError(f"acc and {name} must share one device")


def check_gadget(kp1: int, n: int, lvl: int, planes: int, base_log: int,
                 drop: int = 0) -> None:
    if n < 32 or n & (n - 1):
        raise ValueError(f"N={n} must be a power of two >= 32")
    if not 0 <= drop <= 3 or not 1 <= planes <= 4 - drop:
        raise ValueError(f"{planes} digit planes with drop={drop}; "
                         "1..4-drop supported")
    if lvl < 1 or not 1 <= base_log <= 8 or lvl * base_log > 32:
        raise ValueError(f"base_log={base_log}, level={lvl}: digits must "
                         "fit int8 and level*base_log <= 32")
    # int32 accumulation bound (TfheEngine): terms * (base/2) * 128 < 2^31
    if lvl * kp1 * n * (1 << (base_log - 1)) * 128 >= (1 << 31):
        raise ValueError("shape exceeds the exact int32 accumulation bound")


def cmux_step(acc: torch.Tensor, rot: torch.Tensor, ggsw_i8_row: torch.Tensor,
              base_log: int) -> torch.Tensor:
    """acc + GGSW (x) (X^rot acc - acc) for one LWE key bit.

    acc int32 (B, k+1, N) torus bits; rot int32 (B,), any value (reduced
    mod 2N); ggsw_i8_row int8 (lvl, k+1, k+1, P, 2N), one step's row of
    BootstrapKey.ggsw_i8.  A CUDA tensor launches the Hopper kernel (and
    counts it in ``cmux_step.launches``); a CPU tensor takes the plain
    version.  An empty batch returns an empty tensor and launches
    nothing."""
    check_acc_rot(acc, rot, acc.shape[:1])
    b, kp1, n = acc.shape
    g = ggsw_i8_row
    if g.dim() != 5:
        raise ValueError("ggsw_i8_row must be (lvl, k+1, k+1, P, 2N)")
    lvl, planes = g.shape[0], g.shape[3]
    check_weights(g, (lvl, kp1, kp1, planes, 2 * n), "ggsw_i8_row", acc)
    check_gadget(kp1, n, lvl, planes, base_log)
    if b == 0:
        return torch.empty_like(acc)
    if acc.device.type == "cpu":
        return cmux_step_reference(acc, rot, g, base_log)
    out = torch.empty_like(acc)
    launch(STEP_LIB.load().nfa_cmux_step, "cmux_step", acc.device,
           acc.data_ptr(), rot.data_ptr(), g.data_ptr(), out.data_ptr(),
           b, kp1, lvl, planes, n, base_log)
    cmux_step.launches += 1
    return out


cmux_step.launches = 0


def cmux_step_slabs(acc: torch.Tensor, rot: torch.Tensor, slabs: torch.Tensor,
                    base_log: int, variant: str = "v3") -> torch.Tensor:
    """The same CMux step against prepared diagonal slabs.

    acc int32 (B, k+1, N); rot int32 (B,); slabs int8
    (2*nt-1, lvl*(k+1)*128, (k+1)*P*128) from ``build_diag_slabs``, read
    from device memory.  ``variant`` picks the loop order of the kernel:
    "v3" digit-stationary, "v2" output-stationary; the result is the same
    bit for bit.  A CUDA tensor launches the Hopper kernel (counted per
    variant in ``cmux_step_slabs.launches``); a CPU tensor takes the plain
    version."""
    if variant not in ("v3", "v2"):
        raise ValueError(f"unknown variant {variant!r}: 'v3' or 'v2'")
    check_acc_rot(acc, rot, acc.shape[:1])
    b, kp1, n = acc.shape
    if n % BLOCK:
        raise ValueError(f"N={n} must be a multiple of {BLOCK}")
    if slabs.dim() != 3 or slabs.shape[1] % (kp1 * BLOCK) \
            or slabs.shape[2] % (kp1 * BLOCK):
        raise ValueError("slabs must be (2N/128-1, lvl*(k+1)*128, "
                         "(k+1)*P*128)")
    lvl = slabs.shape[1] // (kp1 * BLOCK)
    planes = slabs.shape[2] // (kp1 * BLOCK)
    check_weights(slabs, (2 * (n // BLOCK) - 1, lvl * kp1 * BLOCK,
                          kp1 * planes * BLOCK), "slabs", acc)
    check_gadget(kp1, n, lvl, planes, base_log)
    if b == 0:
        return torch.empty_like(acc)
    if acc.device.type == "cpu":
        return cmux_step_slabs_reference(acc, rot, slabs, base_log)
    out = torch.empty_like(acc)
    launch(SLABS_LIB.load().nfa_cmux_step_slabs, f"cmux_step_slabs {variant}",
           acc.device, acc.data_ptr(), rot.data_ptr(), slabs.data_ptr(),
           out.data_ptr(), b, kp1, lvl, planes, n, base_log,
           int(variant == "v3"))
    cmux_step_slabs.launches[variant] += 1
    return out


cmux_step_slabs.launches = {"v3": 0, "v2": 0}
