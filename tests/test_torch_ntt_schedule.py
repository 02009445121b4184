"""The schedule of csrc/ntt.cu (K6, K7) mirrored in numpy, against the
port's and the JAX package's NTTContext, bit for bit.

The kernels cannot run here, so this repeats what they do with the tables
the wrapper uploads: which coefficients thread t holds in each pass
(``coeff``), where the exchange stores them (``swz``), the forward's
stores staged through the exchange buffer, which table pair each
butterfly reads, Shoup's product on the (w, w') pairs, the lazy ranges
between stages ([0, 4q) forward, [0, 2q) inverse), and the N^-1 folded
into the inverse's last stage.  The tables themselves are held against
Python integers.  Inputs are random from numpy with a fixed seed.
Tolerance: exact equality -- every value is an integer mod q."""
from fractions import Fraction

import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.ops.ntt import NTTContext as JaxNTT
from node_fhe_accelerate_tpu.ops.u64 import (u64_from_np as jax_from_np,
                                             u64_to_np as jax_to_np)
from node_fhe_accelerate_tpu_torch.core.params import Primes
from node_fhe_accelerate_tpu_torch.core.torus import P1, P2, P_EXT
from node_fhe_accelerate_tpu_torch.ops.ntt import NTTContext
from node_fhe_accelerate_tpu_torch.ops.ntt_pallas import (
    ELEMS_LOG, F64_MAX_Q, MAX_Q, PallasNTT, passes, stage_place,
    twiddle_table)
from node_fhe_accelerate_tpu_torch.ops.u64 import u64_from_np, u64_to_np

torch.set_num_threads(2)

M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
PRIMES = [P1, P2, P_EXT, Primes.Q_60_1]


def mulhi(a, b):
    """High 64 bits of a * b for uint64 arrays, from 32-bit halves."""
    a0, a1, b0, b1 = a & M32, a >> S32, b & M32, b >> S32
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> S32) + (p01 & M32) + (p10 & M32)
    return p11 + (p01 >> S32) + (p10 >> S32) + (mid >> S32)


def shoup(y, w, wq, q):
    """y w mod q in [0, 2q): y w - hi64(y w') q, mod 2^64."""
    with np.errstate(over="ignore"):
        r = y * w - mulhi(y, wq) * np.uint64(q)
    assert (r < np.uint64(2 * q)).all()
    return r


def geometry(logn):
    eb = min(logn, ELEMS_LOG)
    return eb, 1 << eb, 1 << (logn - eb)


def coeff(logn, t, e, c_lo):
    """Index of coefficient e of thread t in a pass whose window starts at
    c_lo (the kernel's ``coeff``)."""
    eb = min(logn, ELEMS_LOG)
    return (t & ((1 << c_lo) - 1)) | (e << c_lo) | \
        ((t >> c_lo) << (c_lo + eb))


def swz(x):
    return x ^ ((x >> 4) & 15)


class ShoupForm:
    """The kernels' wide form (q < 2^62) on uint64 arrays: Shoup's
    products, Harvey's lazy butterflies, values below 4q forward and 2q
    inverse."""

    def __init__(self, q):
        self.q, self.q2 = np.uint64(q), np.uint64(2 * q)
        self.bound = {False: np.uint64(4 * q), True: np.uint64(2 * q)}

    def values(self, x):
        return x.astype(np.uint64)

    def mul(self, y, pair):
        return shoup(y, np.uint64(pair[0]), np.uint64(pair[1]), int(self.q))

    def ct(self, u, v, pair):
        with np.errstate(over="ignore"):
            u = np.where(u >= self.q2, u - self.q2, u)
            v = self.mul(v, pair)
            return u + v, u - v + self.q2

    def gs(self, u, v, pair):
        with np.errstate(over="ignore"):
            s = u + v
            return np.where(s >= self.q2, s - self.q2, s), \
                self.mul(u - v + self.q2, pair)

    def gs_last(self, u, v, c, d):
        with np.errstate(over="ignore"):
            return self.mul(u + v, c), self.mul(u - v + self.q2, d)

    def check(self, x, inverse):
        assert (x < self.bound[inverse]).all()

    def out(self, x, inverse):
        for m in ([self.q] if inverse else [self.q2, self.q]):
            x = np.where(x >= m, x - m, x)
        return x.astype(np.uint64)


def fma(a, b, c):
    """IEEE double fused multiply-add: a b + c rounded once."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


class F64Form:
    """The kernels' narrow form (q < 2^46) on object arrays of Python floats
    (IEEE doubles): each product y w is h = fl(y w), l = fma(y, w, -h),
    Q = fl(fma(h, 1/q, 1.5 2^52) - 1.5 2^52), fma(-Q, q, h) + l; forward
    values stay below 12 q in size, inverse ones below q."""

    ROUND = 6755399441055744.0

    def __init__(self, q):
        self.q, self.qd, self.qinv = q, float(q), 1.0 / float(q)
        self._mul = np.frompyfunc(self._mul1, 2, 1)
        self._reduce = np.frompyfunc(self._reduce1, 1, 1)

    def values(self, x):
        return np.vectorize(float, otypes=[object])(x)

    def _mul1(self, y, w):
        assert abs(y) < 2.0 ** 50
        h = y * w
        quot = fma(h, self.qinv, self.ROUND) - self.ROUND
        r = fma(-quot, self.qd, h) + fma(y, w, -h)
        assert abs(r) <= 0.75 * self.q
        return r

    def _reduce1(self, x):
        quot = fma(x, self.qinv, self.ROUND) - self.ROUND
        return fma(-quot, self.qd, x)

    @staticmethod
    def twiddle(w):
        return np.vectorize(float, otypes=[object])(w)

    def ct(self, u, v, pair):
        v = self._mul(v, self.twiddle(pair[0]))
        return u + v, u - v

    def gs(self, u, v, pair):
        return self._reduce(u + v), self._mul(u - v, self.twiddle(pair[0]))

    def gs_last(self, u, v, c, d):
        return self._mul(u + v, float(c[0])), self._mul(u - v, float(d[0]))

    def check(self, x, inverse):
        bound = (1 if inverse else 12) * self.q
        assert all(abs(v) < bound for v in x.ravel())

    def out(self, x, inverse):
        r = self._reduce(x)
        r = np.where(r < 0, r + self.qd, r)
        assert all(0 <= v < self.q and v == int(v) for v in r.ravel())
        return r.astype(np.uint64)


def kernel_mirror(pk, a, inverse):
    """What ``ntt_transform_kernel`` computes for a (B, N) uint64 batch."""
    logn, n, q = pk.logn, pk.n, pk.ntt.q
    eb, e_count, t_count = geometry(logn)
    form = F64Form(q) if q < F64_MAX_Q else ShoupForm(q)
    t = np.arange(t_count)[:, None]
    e = np.arange(e_count)[None, :]
    table = twiddle_table(pk.ntt, inverse)
    last = pk.last_stage()
    c, d = last[:2], last[2:]
    sched = passes(logn)[::-1] if inverse else passes(logn)
    x = form.values(a[:, coeff(logn, t, e, sched[0][0])])
    for p, (c_lo, r) in enumerate(sched):
        if p:
            buf = np.zeros(a.shape, dtype=x.dtype)
            buf[:, swz(coeff(logn, t, e, sched[p - 1][0]))] = x
            x = buf[:, swz(coeff(logn, t, e, c_lo))]
        h = (t >> c_lo)[:, 0]
        hb = logn - c_lo - eb
        bits = range(eb - r, eb) if inverse else range(eb - 1, eb - r - 1, -1)
        for jj in bits:
            bit, span = c_lo + jj, 1 << jj
            base = n - (n >> bit) if inverse else (n >> (bit + 1)) - 1
            for g in range(e_count // (2 * span)):
                if not (inverse and bit == logn - 1):
                    pair = table[base + (g << hb) + h].T
                for lane in range(span):
                    i = 2 * span * g + lane
                    u, v = x[:, :, i].copy(), x[:, :, i + span].copy()
                    if inverse and bit == logn - 1:
                        out = form.gs_last(u, v, c, d)
                    elif inverse:
                        out = form.gs(u, v, pair)
                    else:
                        out = form.ct(u, v, pair)
                    x[:, :, i], x[:, :, i + span] = out
            form.check(x, inverse)
    out = np.zeros_like(a)
    if inverse:
        out[:, coeff(logn, t, e, sched[-1][0])] = form.out(x, inverse)
        return out
    # the forward's stores, staged through the exchange buffer: 4
    # consecutive coefficients x = 4 (t + k T) + i a thread and store
    buf = np.zeros_like(a)
    buf[:, swz(coeff(logn, t, e, sched[-1][0]))] = form.out(x, inverse)
    row = 4 * (t + np.arange(e_count // 4)[None, :] * t_count)
    for i in range(4):
        out[:, row + i] = buf[:, swz(row + i)]
    return out


def random_batch(n, q):
    a = np.random.default_rng(n + q % 97).integers(0, q, (2, n),
                                                   dtype=np.uint64)
    a[0, :3] = [0, 1, q - 1]
    return a


@pytest.mark.parametrize("inverse", [False, True], ids=["forward",
                                                        "inverse"])
@pytest.mark.parametrize("q", PRIMES, ids=["p1", "p2", "p_ext", "q60"])
@pytest.mark.parametrize("n", [4, 16, 256, 1024])
def test_kernel_schedule_matches_ntt_context(n, q, inverse):
    ntt, a = NTTContext(n, q), random_batch(n, q)
    want = (ntt.inverse if inverse else ntt.forward)(u64_from_np(a))
    np.testing.assert_array_equal(kernel_mirror(PallasNTT(ntt), a, inverse),
                                  u64_to_np(want))


# The JAX transforms compile each stage's shapes at their first eager call
# (~4 s at N = 4, ~6 s at N = 16, ~15 s at N = 1024), so every degree but
# the least is slow; the mirror meets the port's NTTContext at each degree
# in the default tier, and that context is held against JAX's elsewhere.
@pytest.mark.parametrize("inverse", [False, True], ids=["forward",
                                                        "inverse"])
@pytest.mark.parametrize("q", PRIMES, ids=["p1", "p2", "p_ext", "q60"])
@pytest.mark.parametrize("n", [4] + [pytest.param(n, marks=pytest.mark.slow)
                                     for n in (16, 256, 1024)])
def test_kernel_schedule_matches_jax(n, q, inverse):
    ref, a = JaxNTT(n, q), random_batch(n, q)
    want = (ref.inverse if inverse else ref.forward)(jax_from_np(a))
    np.testing.assert_array_equal(
        kernel_mirror(PallasNTT(NTTContext(n, q)), a, inverse),
        jax_to_np(want))


def bit_reverse(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2)


@pytest.mark.parametrize("q", PRIMES, ids=["p1", "p2", "p_ext", "q60"])
@pytest.mark.parametrize("n", [4, 32, 1024])
def test_uploaded_tables_match_python_ints(n, q):
    """Every (w, w') pair of both tables and the folded constants, from
    psi with Python integers."""
    ntt = NTTContext(n, q)
    pk = PallasNTT(ntt)
    logn, eb = ntt.logn, min(ntt.logn, ELEMS_LOG)
    for inverse, root in ((False, ntt.psi), (True, ntt.psi_inv)):
        table = [tuple(map(int, row)) for row in twiddle_table(ntt, inverse)]
        assert len(table) == (n - 2 if inverse else n - 1)
        seen = set()
        for bit in range(logn - 1 if inverse else logn):
            m = n >> (bit + 1)
            _, jj, hb = stage_place(logn, bit)
            base = n - 2 * m if inverse else m - 1
            for e_hi in range(1 << (eb - 1 - jj)):
                for h in range(1 << hb):
                    slot = base + (e_hi << hb) + h
                    w = pow(root, bit_reverse(m + (h << (eb - 1 - jj)
                                                   | e_hi), logn), q)
                    assert table[slot] == (w, (w << 64) // q)
                    seen.add(slot)
        assert seen == set(range(len(table)))
    n_inv = pow(n, -1, q)
    last = n_inv * pow(ntt.psi_inv, n // 2, q) % q
    r = (1 << 64) % q
    assert pk.last_stage() == (n_inv, (n_inv << 64) // q, last,
                               (last << 64) // q)
    assert pk.last_stage(r)[0::2] == (n_inv * r % q, last * r % q)


@pytest.mark.parametrize("logn", range(2, 15))
def test_passes_cover_every_bit_once(logn):
    eb = min(logn, ELEMS_LOG)
    run_bits = [b for c_lo, r in passes(logn)
                for b in range(c_lo + eb - 1, c_lo + eb - r - 1, -1)]
    assert run_bits == list(range(logn))[::-1]
    assert all(0 <= c_lo <= logn - eb for c_lo, _ in passes(logn))


@pytest.mark.parametrize("logn", [8, 10, 12, 14])
def test_exchanges_and_twiddle_reads_are_free_of_bank_conflicts(logn):
    """Each half-warp's u64 exchange accesses, and its reads of the staged
    stores, hit 16 distinct bank pairs; each quarter-warp's 16-byte
    twiddle reads are one address or 8 consecutive pairs."""
    eb, e_count, t_count = geometry(logn)
    lanes = np.arange(t_count).reshape(-1, 16)
    for c_lo, _ in passes(logn):
        for e in range(e_count):
            banks = swz(coeff(logn, lanes, e, c_lo)) % 16
            assert all(len(set(row)) == 16 for row in banks)
    for k in range(e_count // 4):
        for i in range(4):
            banks = swz(4 * (lanes + k * t_count) + i) % 16
            assert all(len(set(row)) == 16 for row in banks)
        h = (np.arange(t_count) >> c_lo).reshape(-1, 8)
        assert all(len(set(row)) == 1 or (np.diff(row) == 1).all()
                   for row in h)


def test_largest_modulus_keeps_lazy_values_in_64_bits():
    assert 4 * (MAX_Q - 1) < 1 << 64 <= 4 * MAX_Q


@pytest.mark.parametrize("q", [P1, P2, (1 << 46) - (1 << 38) + 1],
                         ids=["p1", "p2", "largest_narrow_q"])
def test_narrow_pointwise_product_is_exact(q):
    """K8's pointwise product in the narrow form, mul(a^, reduce(b^)): a^
    and b^ anywhere the forward leaves them (below 12 q in size, < 2^50),
    b^ reduced to at most q / 2 + 1 in size; the product is a^ b^ mod q
    exactly and at most 0.75 q in size (``F64Form`` asserts both bounds)."""
    assert q < F64_MAX_Q and 12 * q < 1 << 50
    form = F64Form(q)
    rng = np.random.default_rng(q % 1009)
    edge = [0, 1, -1, q - 1, q, q + 1, 12 * q - 1, -(12 * q - 1),
            6 * q + q // 2, -(q // 2)]
    vals = edge + [int(v) for v in rng.integers(-(12 * q - 1), 12 * q, 40)]
    for y in vals:
        for w in vals[:len(edge)] + vals[len(edge)::7]:
            wr = form._reduce1(float(w))
            assert abs(wr) <= q / 2 + 1 and (int(wr) - w) % q == 0
            r = form._mul1(float(y), wr)
            assert r == int(r) and (int(r) - y * w) % q == 0
