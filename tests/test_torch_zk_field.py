"""The port's ZK fields (node_fhe_accelerate_tpu_torch/zk/field.py,
field2.py) against the JAX package's, on the CPU, where ``mul``/``square``
take the plain digit algebra (K10's plain version).

Inputs are random from numpy with a seed plus edge values (0, 1, 2, q-1,
q-2, 255, 256).  Each field's JAX ops run under one ``jax.jit``.  Tolerance:
exact equality -- every element is a canonical digit array."""
import jax
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.zk import field as jfield
from node_fhe_accelerate_tpu.zk import field2 as jfield2
from node_fhe_accelerate_tpu_torch.zk import field as tfield
from node_fhe_accelerate_tpu_torch.zk import field2 as tfield2

FIELDS = ["bn254_fq", "bn254_fr", "bls12_381_fq"]
EXP = 0xC0FFEE_1234_5678_9ABC_DEF0_1357_9BDF   # a static exponent


def _values(q: int, seed: int, n: int = 9) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % q for _ in range(n)]
    return vals + [0, 1, 2, q - 1, q - 2, 255, 256]


def _ops(f, a, b, sqrt: bool):
    out = {"add": f.add(a, b), "sub": f.sub(a, b), "neg": f.neg(a),
           "mul": f.mul(a, b), "square": f.square(a),
           "to_mont": f.to_mont(a), "from_mont": f.from_mont(a),
           "inv": f.inv(a), "pow_const": f.pow_const(a, EXP),
           "pow_const 0": f.pow_const(a, 0),
           "is_zero": f.is_zero(a), "eq": f.eq(a, b),
           "select": f.select(f.is_zero(b), a, b)}
    if sqrt:
        out["sqrt"] = f.sqrt(f.square(a))
    return out


@pytest.mark.parametrize("name", FIELDS)
def test_field_ops_match_jax(name):
    jf, tf = getattr(jfield, name)(), getattr(tfield, name)(device="cpu")
    q = tf.q
    xs = _values(q, len(name))
    ys = xs[::-1]
    a, b = tf.encode(xs), tf.encode(ys)
    np.testing.assert_array_equal(a.numpy(), np.asarray(jf.encode(xs)))
    np.testing.assert_array_equal(tf.decode(a), jf.decode(jf.encode(xs)))
    assert tf.from_mont_int(a[3]) == jf.from_mont_int(jf.encode(xs)[3])
    np.testing.assert_array_equal(tf.to_mont_host(xs[4]).numpy(),
                                  np.asarray(jf.to_mont_host(xs[4])))
    sqrt = q % 4 == 3
    want = jax.jit(lambda x, y: _ops(jf, x, y, sqrt))(jf.encode(xs),
                                                      jf.encode(ys))
    got = _ops(tf, a, b, sqrt)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # and the values themselves
    assert list(tf.decode(got["mul"])) == [x * y % q for x, y in zip(xs, ys)]
    assert list(tf.decode(got["inv"])) == [pow(x, -1, q) if x else 0
                                           for x in xs]
    if not sqrt:
        with pytest.raises(NotImplementedError):
            tf.sqrt(a)


def test_field_broadcasts_a_constant_row():
    """A (D,) constant times a (..., D) batch (Poseidon's MDS products)."""
    tf = tfield.bn254_fr(device="cpu")
    xs = _values(tf.q, 3)
    a = tf.encode(xs).reshape(4, 4, -1)
    c = tf.encode([12345])[0]
    got = tf.mul(c, a)
    assert got.shape == a.shape
    np.testing.assert_array_equal(tf.decode(got.reshape(16, -1)),
                                  [12345 * x % tf.q for x in xs])


def test_field_rejects_bad_moduli():
    for q, d in (((1 << 256) - 189, 32),        # 2q >= R at D = 32
                 (1 << 100, 32),                # even
                 (2 ** 521 - 1, 48)):           # does not fit
        with pytest.raises(ValueError):
            tfield.Field(q, d, device="cpu")


def _ops2(f, a, b):
    return {"add": f.add(a, b), "sub": f.sub(a, b), "neg": f.neg(a),
            "mul": f.mul(a, b), "square": f.square(a), "inv": f.inv(a),
            "is_zero": f.is_zero(a), "eq": f.eq(a, b),
            "select": f.select(f.is_zero(b), a, b)}


def test_field2_ops_match_jax():
    """bn254_fq2; bls12_381_fq2 runs the same code over its base field."""
    jf, tf = jfield2.bn254_fq2(), tfield2.bn254_fq2(device="cpu")
    q = tf.q
    c0, c1 = _values(q, 7), _values(q, 8)[::-1]
    xs = list(zip(c0, c1)) + [0, (0, 1)]
    ys = xs[::-1]
    a, b = tf.encode(xs), tf.encode(ys)
    np.testing.assert_array_equal(a.numpy(), np.asarray(jf.encode(xs)))
    for g, w in zip(tf.decode(a), jf.decode(jf.encode(xs))):
        np.testing.assert_array_equal(g, w)
    want = jax.jit(lambda x, y: _ops2(jf, x, y))(jf.encode(xs),
                                                 jf.encode(ys))
    got = _ops2(tf, a, b)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tf.one_mont.numpy(),
                                  np.asarray(jf.one_mont))
    assert torch.equal(tf.mul(a, tf.one_mont), a)
