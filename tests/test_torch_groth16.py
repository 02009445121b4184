"""The port's Groth16, circuits and commitments (node_fhe_accelerate_tpu_
torch/zk/groth16.py, circuits.py, commitments.py) and the SNARK state
carried across by ``convert.py``, against the JAX package, on the CPU.

* circuits: the EligibilityCircuit's R1CS, gadget Poseidon and leaves;
* Groth16 at EligibilityCircuit(2) from one seed: the port's setup (every
  query point) and proof equal the JAX package's, whose setup takes ~25 s
  on the CPU: the default tier holds the port to digests and the proof
  committed in ``tests/torch_snark_vectors.json``, the ``slow`` tier makes
  them with the JAX package live; the h limbs of the device branch (the
  card's digit-plane pipeline, on CPU tensors) equal ``_h_limbs_host``;
* a small circuit (x*y = z) live in both packages: equal setups and
  proofs, a JAX setup carried into the port proves there, and each
  package's verifier accepts the other's proofs and refuses tampered ones;
* KZG (BN254 and BLS12-381): setup, commit and open equal the JAX
  package's; a carried JAX setup commits and opens in the port and both
  verifiers accept; FRI proofs equal.

Tolerance: exact equality."""
import hashlib
import json
import os

import numpy as np
import pytest

from node_fhe_accelerate_tpu.zk import circuits as jcirc
from node_fhe_accelerate_tpu.zk import commitments as jcom
from node_fhe_accelerate_tpu.zk import groth16 as jg
from node_fhe_accelerate_tpu.zk import pairing as jpr
from node_fhe_accelerate_tpu.zk.curve import bls12_381_g1 as jbls_g1
from node_fhe_accelerate_tpu_torch import convert
from node_fhe_accelerate_tpu_torch.convert import points_to_numpy
from node_fhe_accelerate_tpu_torch.device import tensor_to_u32
from node_fhe_accelerate_tpu_torch.zk import circuits as tcirc
from node_fhe_accelerate_tpu_torch.zk import commitments as tcom
from node_fhe_accelerate_tpu_torch.zk import groth16 as tg
from node_fhe_accelerate_tpu_torch.zk import hashes as th
from node_fhe_accelerate_tpu_torch.zk.curve import bls12_381_g1, bn254_g1
from node_fhe_accelerate_tpu_torch.zk.field import BN254_FR as R

VECTORS = os.path.join(os.path.dirname(__file__), "torch_snark_vectors.json")
SEED = 5


# ---------------------------------------------------------------------------
# helpers shared by the default and the slow tier
# ---------------------------------------------------------------------------


def g1_rows(curve, pts):
    """Batched points -> [[x, y, inf], ...] ints (None -> [])."""
    if pts is None:
        return []
    x, y, inf = curve.to_affine_ints(pts)
    return [[int(a), int(b), bool(i)] for a, b, i in
            zip(np.atleast_1d(x), np.atleast_1d(y), np.atleast_1d(inf))]


def g2_row(p):
    return None if p is None else [[int(c) for c in x.coeffs] for x in p]


def setup_values(curve, s) -> list:
    """Every point of a Groth16 setup (either package's), affine."""
    out = [g1_rows(curve, getattr(s, k)) for k in
           ("alpha_g1", "beta_g1", "delta_g1", "a_query", "b_query_g1",
            "l_query", "h_query", "ic")]
    out += [g2_row(s.beta_g2), g2_row(s.delta_g2), g2_row(s.gamma_g2)]
    out.append([g2_row(p) for p in s.b_query_g2])
    return out


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, default=str).encode()).hexdigest()


def proof_values(p) -> dict:
    return {"a": None if p.a is None else [str(v) for v in p.a],
            "b": [[str(c) for c in x] for x in g2_row(p.b)],
            "c": None if p.c is None else [str(v) for v in p.c]}


def eligibility_case(circ_mod, hashes_mod, device_kw):
    """EligibilityCircuit(2) with a voter at leaf 0 of a 4-leaf tree:
    (circuit, assignment, public inputs)."""
    circ = circ_mod.EligibilityCircuit(2, **device_kw)
    vid, secret = 12345, 67890
    p = circ.poseidon
    f = p.f
    tree = hashes_mod.MerkleTree(p, f.encode([circ.leaf(v) for v in
                                             (vid, 5, 6, 7)]))
    path = [int(f.decode(s[None])[0]) for s in tree.path(0)]
    root = int(f.decode(tree.root[None])[0])
    wit = circ.generate_witness(vid, secret, path, [0, 0], root)
    return circ, wit.assignment, wit.public_inputs


def mult_circuit(g):
    """x * y = z, z public (the JAX package's tests/test_groth16.py)."""
    cb = g.CircuitBuilder()
    z = cb.public_input()
    x = cb.private_input()
    y = cb.private_input()
    xy = cb.mul(x, y)
    cb.assert_equal(xy, z)
    return cb.build(), {z: 42, x: 6, y: 7, xy: 42}


def jax_proof(p):
    """A port Groth16Proof -> the JAX package's type."""
    def b(v):
        return None if v is None else tuple(jpr.FQ2(list(c.coeffs))
                                            for c in v)
    return jg.Groth16Proof(a=p.a, b=b(p.b), c=p.c)


def swapped(p, mod):
    return mod.Groth16Proof(a=p.c, b=p.b, c=p.a)


# ---------------------------------------------------------------------------
# circuits
# ---------------------------------------------------------------------------


LEAF_IDS = [3, 12345, R - 1]


def assignment_digest(assign) -> str:
    return digest(sorted((int(k), str(v)) for k, v in assign.items()))


@pytest.mark.parametrize("depth", [1, 2])
def test_eligibility_r1cs_matches_jax(depth):
    """The R1CS (pure Python in both packages) is the JAX package's; the
    batched leaves equal the single ones and the JAX package's (committed:
    its Poseidon takes ~20 s of XLA compile on the CPU)."""
    j = jcirc.EligibilityCircuit(depth)
    t = tcirc.EligibilityCircuit(depth, device="cpu")
    assert (t.r1cs.num_vars, t.r1cs.num_public) == \
        (j.r1cs.num_vars, j.r1cs.num_public)
    assert t.r1cs.constraints == j.r1cs.constraints
    with open(VECTORS) as fh:
        want = json.load(fh)["eligibility_leaves"]
    assert [str(v) for v in t.leaves(LEAF_IDS)] == want
    assert [str(t.leaf(v)) for v in LEAF_IDS] == want


def test_eligibility_witness_matches_jax_and_satisfies():
    tc, tassign, tpub = eligibility_case(tcirc, th, {"device": "cpu"})
    with open(VECTORS) as fh:
        want = json.load(fh)["groth16_elig2"]
    assert assignment_digest(tassign) == want["assignment"]
    assert [str(v) for v in tpub] == want["publics"]
    tg.evaluate_witness(tc.r1cs, tassign)
    bad = dict(tassign)
    bad[tc._remap[tc.voter_secret_wire]] += 1
    with pytest.raises(ValueError, match="satisfy"):
        tg.evaluate_witness(tc.r1cs, bad)


# ---------------------------------------------------------------------------
# Groth16 at EligibilityCircuit(2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def elig():
    circ, assign, pub = eligibility_case(tcirc, th, {"device": "cpu"})
    prover = tg.Groth16Prover(rng_seed=SEED, device="cpu")
    setup = prover.setup(circ.r1cs)
    proof = prover.prove(setup, assign)
    return circ, assign, pub, prover, setup, proof


def test_eligibility_setup_and_proof_match_committed_jax(elig):
    _, _, pub, _, setup, proof = elig
    with open(VECTORS) as fh:
        want = json.load(fh)["groth16_elig2"]
    assert setup.r1cs.num_constraints == want["constraints"]
    assert digest(setup_values(bn254_g1("cpu"), setup)) == want["setup"]
    assert proof_values(proof) == want["proof"]
    assert [str(v) for v in pub] == want["publics"]


def test_eligibility_proof_verifies_and_tamper_refused(elig):
    _, _, pub, _, setup, proof = elig
    v = tg.Groth16Verifier("cpu")
    assert v.verify(setup, pub, proof)
    assert not v.verify(setup, [pub[0] + 1, pub[1]], proof)
    assert not v.verify(setup, pub, swapped(proof, tg))
    assert not v.verify(setup, pub[:1], proof)


def test_h_limbs_device_branch_equals_host(elig):
    """The card's h-pipeline (sparse R1CS eval, Fr NTT, u32 repack) on CPU
    tensors equals ``_h_limbs_host``, and a bad witness is refused by
    both."""
    _, assign, _, prover, setup, _ = elig
    cc = prover.compiled(setup)
    w = tg.evaluate_witness(setup.r1cs, assign)
    host = cc._h_limbs_host(w)
    dev = cc.h_limbs(w, backend="device")
    assert (tensor_to_u32(dev) == host).all()
    assert (tensor_to_u32(cc.h_limbs(w)) == host).all()     # default: host
    bad = list(w)
    bad[-1] = (bad[-1] + 1) % R
    for backend in ("host", "device"):
        with pytest.raises(ValueError, match="satisfy"):
            cc.h_limbs(bad, backend=backend)


# ---------------------------------------------------------------------------
# a small circuit live in both packages, and the state carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mult():
    jr, assign = mult_circuit(jg)
    jp = jg.Groth16Prover(rng_seed=SEED)
    js = jp.setup(jr)
    jproof = jp.prove(js, assign)
    tr, _ = mult_circuit(tg)
    tp = tg.Groth16Prover(rng_seed=SEED, device="cpu")
    ts = tp.setup(tr)
    tproof = tp.prove(ts, assign)
    return assign, js, jproof, ts, tproof


def test_mult_setup_and_proof_match_jax(mult):
    _, js, jproof, ts, tproof = mult
    assert setup_values(bn254_g1("cpu"), ts) == setup_values(
        bn254_g1("cpu"), convert.groth16_setup_from_jax(js, "cpu"))
    assert proof_values(tproof) == proof_values(
        convert.groth16_proof_from_jax(jproof))


def test_verifiers_accept_each_others_proofs(mult):
    _, js, jproof, ts, tproof = mult
    jv, tv = jg.Groth16Verifier(), tg.Groth16Verifier("cpu")
    assert jv.verify(js, [42], jax_proof(tproof))
    assert tv.verify(ts, [42], convert.groth16_proof_from_jax(jproof))
    assert not jv.verify(js, [43], jax_proof(tproof))
    assert not tv.verify(ts, [42], swapped(
        convert.groth16_proof_from_jax(jproof), tg))
    assert not jv.verify(js, [42], swapped(jax_proof(tproof), jg))


def test_jax_setup_proves_in_the_port(mult):
    """A JAX Groth16Setup carried across proves in the port (the compiled
    circuit rebuilt from the R1CS, also through the device branch on CPU
    tensors), and both verifiers accept the proof."""
    assign, js, _, _, _ = mult
    carried = convert.groth16_setup_from_jax(js, "cpu")
    prover = tg.Groth16Prover(rng_seed=9, device="cpu")
    proof = prover.prove(carried, assign)
    assert tg.Groth16Verifier("cpu").verify(carried, [42], proof)
    assert jg.Groth16Verifier().verify(js, [42], jax_proof(proof))
    # the rebuilt circuit's device h-pipeline, on CPU tensors
    cc = prover.compiled(carried)
    w = tg.evaluate_witness(carried.r1cs, assign)
    assert (tensor_to_u32(cc.h_limbs(w, backend="device"))
            == cc._h_limbs_host(w)).all()


# ---------------------------------------------------------------------------
# KZG and FRI
# ---------------------------------------------------------------------------


def kzg_pair(curve_name):
    if curve_name == "bn254":
        return jcom.KZGScheme(), tcom.KZGScheme(bn254_g1("cpu"))
    return jcom.KZGScheme(jbls_g1()), tcom.KZGScheme(bls12_381_g1("cpu"))


KZG_COEFFS = [5, 0, 3, 1, 9]


@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381"])
def test_kzg_matches_jax_and_carries_across(curve_name):
    """Setup, commit and open (host paths in both packages on the CPU)
    equal the JAX package's; a JAX setup carried across commits and opens
    in the port, and the port's pairing check accepts."""
    jscheme, tscheme = kzg_pair(curve_name)
    tcurve = tscheme.curve
    js = jscheme.setup(max_degree=8, seed=3)
    ts = tscheme.setup(max_degree=8, seed=3)
    carried = convert.kzg_setup_from_jax(js, "cpu")
    assert ts.tau == js.tau == carried.tau
    assert g1_rows(tcurve, ts.powers) == g1_rows(tcurve, carried.powers)
    assert (g2_row(ts.h2), g2_row(ts.tau_h2)) == \
        (g2_row(js.h2), g2_row(js.tau_h2))
    com = tscheme.commit(KZG_COEFFS, carried)
    assert g1_rows(tcurve, com) == g1_rows(tcurve, convert.points_from_numpy(
        tcurve, [np.asarray(c) for c in jscheme.commit(KZG_COEFFS, js)]))
    value, proof = tscheme.open(KZG_COEFFS, 7, carried)
    jvalue, jproof = jscheme.open(KZG_COEFFS, 7, js)
    assert value == jvalue == tcom._poly_eval(KZG_COEFFS, 7, tscheme.r)
    assert g1_rows(tcurve, proof) == g1_rows(tcurve, convert.points_from_numpy(
        tcurve, [np.asarray(c) for c in jproof]))
    assert tscheme.verify(com, 7, value, proof, carried)
    assert not tscheme.verify(com, 7, value + 1, proof, carried)


def test_kzg_degree_bound():
    scheme = tcom.KZGScheme(bn254_g1("cpu"))
    setup = scheme.setup(max_degree=4, seed=1)
    with pytest.raises(ValueError, match="degree"):
        scheme.commit([1] * 6, setup)


FRI_CFG = dict(domain_log=3, num_queries=1)
FRI_COEFFS = [3, 1, 4, 1]


def fri_values(f, proof) -> dict:
    return {"roots": [str(int(f.decode(r[None])[0]))
                      for r in proof.layer_roots],
            "final": [str(c) for c in proof.final_poly],
            "queries": [[[q["i0"], str(q["v0"]), str(q["v1"])] for q in per]
                        for per in proof.queries]}


def test_fri_proof_matches_jax():
    """The port's FRI proof equals the JAX package's (committed: its
    Poseidon Merkle layers take ~100 s of XLA compile on the CPU);
    verifies, and a tampered final polynomial is refused."""
    tf = tcom.FRIScheme(tcom.FRIConfig(**FRI_CFG), device="cpu")
    tp = tf.prove(FRI_COEFFS)
    with open(VECTORS) as fh:
        assert fri_values(tf.f, tp) == json.load(fh)["fri"]
    assert tf.verify(tp)
    tp.final_poly[0] = (tp.final_poly[0] + 1) % tf.r
    assert not tf.verify(tp)


@pytest.mark.slow
def test_kzg_and_fri_match_jax_live():
    """The JAX package's KZG verifier on the port's commitment and opening,
    the port's dev check (the setup secret), and the JAX FRI proof, now."""
    import jax.numpy as jnp
    for name in ("bn254", "bls12_381"):
        jscheme, tscheme = kzg_pair(name)
        js = jscheme.setup(max_degree=8, seed=3)
        carried = convert.kzg_setup_from_jax(js, "cpu")
        com = tscheme.commit(KZG_COEFFS, carried)
        value, proof = tscheme.open(KZG_COEFFS, 7, carried)

        def j(p):
            return tuple(jnp.asarray(c) for c in points_to_numpy(p))
        assert jscheme.verify(j(com), 7, value, j(proof), js)
        assert jscheme.verify_dev(j(com), 7, value, j(proof), js)
        assert tscheme.verify_dev(com, 7, value, proof, carried)
        assert not tscheme.verify_dev(com, 7, value + 1, proof, carried)
    jf = jcom.FRIScheme(jcom.FRIConfig(**FRI_CFG))
    with open(VECTORS) as fh:
        assert fri_values(jf.f, jf.prove(FRI_COEFFS)) == \
            json.load(fh)["fri"]


# ---------------------------------------------------------------------------
# live JAX at EligibilityCircuit(2)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_eligibility_matches_jax_live(elig):
    """The JAX package's seeded setup and proof at EligibilityCircuit(2),
    now: equal to the port's and to the committed vectors; the JAX setup
    carried across proves in the port, and both verifiers accept."""
    from node_fhe_accelerate_tpu.zk import hashes as jh
    _, _, pub, _, setup, proof = elig
    jc, jassign, jpub = eligibility_case(jcirc, jh, {})
    jp = jg.Groth16Prover(rng_seed=SEED)
    js = jp.setup(jc.r1cs)
    jproof = jp.prove(js, jassign)
    assert jpub == pub
    with open(VECTORS) as fh:
        vec = json.load(fh)
    assert assignment_digest(jassign) == vec["groth16_elig2"]["assignment"]
    assert [str(jc.leaf(v)) for v in LEAF_IDS] == vec["eligibility_leaves"]
    curve = bn254_g1("cpu")
    want = setup_values(curve, convert.groth16_setup_from_jax(js, "cpu"))
    assert setup_values(curve, setup) == want
    got_proof = convert.groth16_proof_from_jax(jproof)
    assert proof_values(got_proof) == proof_values(proof)
    with open(VECTORS) as fh:
        vec = json.load(fh)["groth16_elig2"]
    assert (digest(want), proof_values(got_proof)) == \
        (vec["setup"], vec["proof"])
    carried = convert.groth16_setup_from_jax(js, "cpu")
    p2 = tg.Groth16Prover(rng_seed=11, device="cpu").prove(carried, jassign)
    assert tg.Groth16Verifier("cpu").verify(carried, jpub, p2)
    assert jg.Groth16Verifier().verify(js, jpub, jax_proof(p2))
