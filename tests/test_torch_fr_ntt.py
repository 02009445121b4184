"""The port's Fr NTT (node_fhe_accelerate_tpu_torch/zk/fr_ntt.py) against the
JAX package's (node_fhe_accelerate_tpu/zk/fr_ntt.py), on the CPU.

Inputs are field elements drawn from numpy with a seed.  The digit-plane
transforms (the code the card runs, with the plain field products on CPU
tensors) and the host ``*_ints`` twins are held equal to the JAX package's
``*_ints`` twins live, and to the outputs of the JAX package's digit-plane
transforms through their SHA-256 digests committed in
``tests/torch_snark_vectors.json`` (the ``slow`` test recomputes those
digests with the JAX package live).  Tolerance: exact equality."""
import hashlib
import json
import os

import numpy as np
import pytest

from node_fhe_accelerate_tpu.zk import field as jfield
from node_fhe_accelerate_tpu.zk import fr_ntt as jfr
from node_fhe_accelerate_tpu_torch.zk import field as tfield
from node_fhe_accelerate_tpu_torch.zk import fr_ntt as tfr

VECTORS = os.path.join(os.path.dirname(__file__), "torch_snark_vectors.json")
CASES = [("bn254", 8), ("bn254", 64), ("bn254", 256), ("bls12_381", 8),
         ("bls12_381", 32)]
OPS = ("forward", "inverse", "evaluate", "interpolate", "negacyclic_mul")


def _fields(name):
    if name == "bn254":
        return jfield.bn254_fr, tfield.bn254_fr
    return jfield.bls12_381_fr, tfield.bls12_381_fr


def inputs(q, d, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % q for _ in range(2 * d)]


def digest(ints) -> str:
    return hashlib.sha256(
        json.dumps([str(int(v)) for v in ints]).encode()).hexdigest()


def run_planes(ntt, vals):
    """Each op of ``ntt`` on the digit planes of ``vals`` -> decoded
    ints."""
    f, d = ntt.f, ntt.d
    a, b = f.encode(vals[:d]), f.encode(vals[d:])
    outs = {"forward": ntt.forward(a), "inverse": ntt.inverse(a),
            "evaluate": ntt.evaluate(a), "interpolate": ntt.interpolate(a),
            "negacyclic_mul": ntt.negacyclic_mul(a, b)}
    return {k: [int(x) for x in f.decode(v)] for k, v in outs.items()}


def run_ints(ntt, vals):
    d = ntt.d
    a = np.array(vals[:d], dtype=object)
    b = np.array(vals[d:], dtype=object)
    outs = {"forward": ntt.forward_ints(a), "inverse": ntt.inverse_ints(a),
            "evaluate": ntt.evaluate_ints(a),
            "interpolate": ntt.interpolate_ints(a),
            "negacyclic_mul": ntt.negacyclic_mul_ints(a, b)}
    return {k: [int(x) for x in v] for k, v in outs.items()}


@pytest.mark.parametrize("name,d", CASES)
def test_port_matches_jax_host_twins(name, d):
    """Both branches of the port (digit planes, host ints) equal the JAX
    package's host twins, op by op; the domain (psi, points) is the
    same."""
    jf, tf = _fields(name)
    jn = jfr.FrNtt(jf(), d)
    tn = tfr.FrNtt(tf("cpu"), d)
    assert (tn.psi, tn.points) == (jn.psi, jn.points)
    vals = inputs(jn.f.q, d, d)
    want = run_ints(jn, vals)
    assert run_ints(tn, vals) == want
    assert run_planes(tn, vals) == want


@pytest.mark.parametrize("name,d", CASES)
def test_planes_match_committed_jax_vectors(name, d):
    """The port's digit-plane transforms equal the JAX package's digit-plane
    transforms (their digests, committed)."""
    with open(VECTORS) as fh:
        want = json.load(fh)["fr_ntt"][f"{name}_{d}"]
    tn = tfr.FrNtt(_fields(name)[1]("cpu"), d)
    got = run_planes(tn, inputs(tn.f.q, d, d))
    assert {k: digest(v) for k, v in got.items()} == want


def test_round_trip_and_vanishing():
    """interpolate inverts evaluate; x^d + 1 vanishes on every point."""
    tn = tfr.FrNtt(tfield.bn254_fr("cpu"), 16)
    q = tn.f.q
    vals = inputs(q, 16, 3)[:16]
    back = tn.interpolate(tn.evaluate(tn.f.encode(vals)))
    assert [int(x) for x in tn.f.decode(back)] == vals
    assert all((pow(x, 16, q) + 1) % q == 0 for x in tn.points)


def test_rejects_bad_sizes():
    f = tfield.bn254_fr("cpu")
    for d in (1, 12):
        with pytest.raises(ValueError):
            tfr.FrNtt(f, d)
    with pytest.raises(ValueError, match="2-adicity"):
        tfr.FrNtt(f, 1 << 28)


@pytest.mark.slow
@pytest.mark.parametrize("name,d", CASES)
def test_planes_match_jax_planes_live(name, d):
    """The JAX package's digit-plane transforms, now: equal to the port and
    to the committed digests."""
    jf, tf = _fields(name)
    jn = jfr.FrNtt(jf(), d)
    vals = inputs(jn.f.q, d, d)
    want = run_planes(jn, vals)
    assert run_planes(tfr.FrNtt(tf("cpu"), d), vals) == want
    with open(VECTORS) as fh:
        assert json.load(fh)["fr_ntt"][f"{name}_{d}"] == \
            {k: digest(v) for k, v in want.items()}
