"""Big-integer arithmetic in 8-bit digit planes (counterpart of
node_fhe_accelerate_tpu/ops/digits.py).

* an integer is (..., D) int32 digits, base 256, little-endian, strictly
  canonical (each digit in [0, 255]);
* a product is a digit convolution: every column sum is < D * 255^2 < 2^22,
  exact in int32;
* carries resolve in a few magnitude rounds and one carry lookahead built
  from two ``torch.cummax`` scans -- no O(D) ripple chains.

This is the plain algebra of the ZK fields (``zk/field.py``); on the card
the field multiply runs as a kernel (``ops/digits_pallas.py``) and only the
cheap add/sub glue runs here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = [
    "digits_from_int", "digits_from_ints", "digits_to_ints",
    "conv_full", "conv_const", "conv_square",
    "exact_norm", "add_digits",
    "sub_digits", "geq_digits", "is_zero_digits", "eq_digits", "select",
]


# ---------------------------------------------------------------------------
# Host conversions
# ---------------------------------------------------------------------------


def digits_from_int(value: int, d: int, device=None):
    if value >> (8 * d):
        raise ValueError("value does not fit in digit count")
    out = np.array([(value >> (8 * i)) & 0xFF for i in range(d)], np.int32)
    return torch.from_numpy(out).to(resolve_device(device))


def digits_from_ints(values, d: int, device=None):
    """Host ints (object array) -> (..., d) strict digit planes, through
    one bulk ``int.to_bytes`` per value."""
    values = np.asarray(values, dtype=object)
    buf = b"".join(int(v).to_bytes(d, "little") for v in values.reshape(-1))
    out = np.frombuffer(buf, dtype=np.uint8).astype(np.int32)
    return torch.from_numpy(out.reshape(values.shape + (d,))).to(
        resolve_device(device))


def digits_to_ints(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr, dtype=np.int64)
    out = np.zeros(a.shape[:-1], dtype=object)
    for i in range(a.shape[-1]):
        out += a[..., i].astype(object) << (8 * i)
    return out


# ---------------------------------------------------------------------------
# Convolution products
# ---------------------------------------------------------------------------

def _flat(x, batch_shape, d):
    return x.expand(batch_shape + (d,)).reshape(-1, d)


def conv_full(a, b, out_len: int | None = None):
    """Digit convolution columns of a*b: (..., out_len) int32, columns
    < 2^22; a and b broadcast over their batch axes.

    Column k is sum_i a_i * b_{k-i}: one product of the reversed a against
    the length-D windows of the zero-padded b (``unfold``, a view) and one
    int32 sum -- a handful of tensor ops whatever D, so a small batch is
    not paced by per-op overhead."""
    d = a.shape[-1]
    if out_len is None:
        out_len = 2 * d
    batch_shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    af, bf = _flat(a, batch_shape, d), _flat(b, batch_shape, d)
    # win[:, k, j] = b[k + j - (d - 1)], zero outside [0, d)
    win = F.pad(bf, (d - 1, out_len)).unfold(-1, d, 1)[:, :out_len]
    cols = (win * af.flip(-1)[:, None, :]).sum(-1, dtype=torch.int32)
    return cols.reshape(batch_shape + (out_len,))


def conv_square(a, out_len: int | None = None):
    """Digit convolution of a*a with the triangular halving: the diagonal
    a_i^2 at column 2i plus twice every a_i a_j with i < j."""
    d = a.shape[-1]
    if out_len is None:
        out_len = 2 * d
    batch_shape = a.shape[:-1]
    af = a.reshape(-1, d)
    sq = af * af
    diag = torch.stack([sq, torch.zeros_like(sq)], dim=-1).reshape(-1, 2 * d)
    acc = af.new_zeros((af.shape[0], out_len))
    w0 = min(2 * d, out_len)
    acc[:, :w0] = diag[:, :w0]
    for i in range(min(d - 1, out_len)):
        w = min(d - (i + 1), out_len - (2 * i + 1))
        if w <= 0:
            continue
        acc[:, 2 * i + 1:2 * i + 1 + w] += \
            2 * af[:, i:i + 1] * af[:, i + 1:i + 1 + w]
    return acc.reshape(batch_shape + (out_len,))


_toep_cache: dict = {}


def conv_const(a, const_digits, out_len: int | None = None):
    """Digit convolution against a CONSTANT operand (the q and q' of a
    Montgomery reduce): cols = a @ Toeplitz(const), one float64 matmul.

    Inputs are <= 255 and every column sum is < 2^22, so float64 is exact,
    and no TF32 or matmul-precision setting touches a float64 product.
    const_digits: host (D2,) strict digit array."""
    cd = np.asarray(const_digits, dtype=np.int64)
    d = a.shape[-1]
    d2 = cd.shape[0]
    if out_len is None:
        out_len = d + d2
    key = (cd.tobytes(), d, out_len, str(a.device))
    m = _toep_cache.get(key)
    if m is None:
        mh = np.zeros((d, out_len), dtype=np.float64)
        for i in range(d):
            for j in range(d2):
                if i + j < out_len:
                    mh[i, i + j] = float(cd[j])
        m = _toep_cache[key] = torch.from_numpy(mh).to(a.device)
    batch_shape = a.shape[:-1]
    cols = a.reshape(-1, d).to(torch.float64) @ m
    return cols.to(torch.int32).reshape(batch_shape + (out_len,))


# ---------------------------------------------------------------------------
# Carry resolution
# ---------------------------------------------------------------------------


_iota_cache: dict = {}


def _iota(n: int, device, dtype):
    """1..n as a tensor, cached per device and dtype."""
    key = (n, str(device), dtype)
    t = _iota_cache.get(key)
    if t is None:
        t = _iota_cache[key] = torch.arange(1, n + 1, dtype=dtype,
                                            device=device)
    return t


def _shift_up(x):
    """x moved one digit up along the last axis, zero in digit 0."""
    return F.pad(x[..., :-1], (1, 0))


def _ks_add(lo, carry_in_bits):
    """Exact sum of lo (digits <= 255) + carry bits (<= 1 per digit).

    Carry lookahead via two cummax scans: a carry flows out of digit i iff
    the most recent 'generate' (sum > 255) at or below i is more recent
    than the most recent 'kill' (sum < 255).  Returns (strict digits,
    carry_out bool)."""
    s = lo + carry_in_bits                    # <= 256
    iota = _iota(s.shape[-1], s.device, s.dtype)
    cg = torch.cummax(torch.where(s > 255, iota, 0), dim=-1).values
    ck = torch.cummax(torch.where(s < 255, iota, 0), dim=-1).values
    carry_out_of = cg > ck                    # carry flows out of digit i
    out = (s + _shift_up(carry_out_of.to(s.dtype))) & 255
    return out, carry_out_of[..., -1]


def exact_norm(cols, rounds: int = 3, dim: int = -1):
    """Normalize nonnegative int32 columns (< 2^22) along ``dim`` to strict
    digits.

    `rounds` magnitude-reduction rounds bring every column to <= 256, then
    one lookahead pass resolves the remaining single-bit carries exactly
    (one round suffices for columns up to 2^16 - 1).  Returns (digits,
    carry_out int32).  Carries beyond the array are ignored by the caller
    when the value bound guarantees they are zero."""
    x = cols.movedim(dim, -1)
    dropped = 0
    for _ in range(rounds):
        hi = x >> 8
        dropped = dropped + hi[..., -1]
        x = (x & 255) + _shift_up(hi)
    cb = x >> 8
    out, ks_carry = _ks_add(x & 255, _shift_up(cb))
    return out.movedim(-1, dim), dropped + cb[..., -1] + ks_carry


def add_digits(a, b, plus_one: bool = False):
    """Exact a + b (+1) on strict digit arrays: (digits, carry_out)."""
    s = a + b
    if plus_one:
        s[..., 0] += 1
    return exact_norm(s, rounds=1)


def comp255(a):
    return 255 - a


def sub_digits(a, b):
    """Exact a - b on strict arrays: returns (digits, a_geq_b bool).

    a - b = a + comp(b) + 1 - 2^(8D); the top carry is exactly [a >= b],
    and when it is 0 the digits hold a - b + 2^(8D)."""
    d, c = add_digits(a, comp255(b), plus_one=True)
    return d, c != 0


def geq_digits(a, b):
    _, ge = sub_digits(a, b)
    return ge


def is_zero_digits(a):
    return (a == 0).all(dim=-1)


def eq_digits(a, b):
    return (a == b).all(dim=-1)


def select(pred, a, b):
    return torch.where(pred[..., None], a, b)
