"""The port's PLONK (node_fhe_accelerate_tpu_torch/zk/plonk.py) against the
JAX package's (node_fhe_accelerate_tpu/zk/plonk.py), on the CPU.

The JAX prover runs its jitted NTT pipelines even on the CPU (~70 s of XLA
compile for the 4-gate circuit), so the default tier holds the port's
seeded proof of x*y = z field for field against the proof the JAX package
made from the same seed, committed in ``tests/torch_snark_vectors.json``:

    c = PlonkCircuit(); z = c.public_input(); x = c.new_var()
    y = c.new_var(); xy = c.mul(x, y); c.assert_equal(xy, z)
    prover = PlonkProver(rng_seed=3); setup = prover.setup(c, kzg_seed=1)
    proof = prover.prove(setup, {z: 42, x: 6, y: 7, xy: 42}, [42])

and the ``slow`` tier makes it with the JAX package live.  The setups of
both packages (host KZG and the NTT interpolation) are compared live, the
JAX setup carried into the port by ``convert.py``, and each package's
verifier accepts the other's proof and refuses tampered ones.
Tolerance: exact equality."""
import json
import os

import pytest

from node_fhe_accelerate_tpu.zk import plonk as jp
from node_fhe_accelerate_tpu_torch import convert
from node_fhe_accelerate_tpu_torch.zk import plonk as tp

VECTORS = os.path.join(os.path.dirname(__file__), "torch_snark_vectors.json")


def mult_circuit(mod):
    c = mod.PlonkCircuit()
    z = c.public_input()
    x = c.new_var()
    y = c.new_var()
    xy = c.mul(x, y)
    c.assert_equal(xy, z)
    return c, {z: 42, x: 6, y: 7, xy: 42}


def proof_values(p) -> dict:
    return {"commits": {k: [str(v[0]), str(v[1]), bool(v[2])]
                        for k, v in sorted(p.commits.items())},
            "evals": {k: str(v) for k, v in sorted(p.evals.items())}}


def setup_values(s) -> dict:
    def aff(p):
        x, y, inf = tp._aff3(s.kzg.curve, p)
        return [str(x), str(y), bool(inf)]
    return {"n": s.n, "domain": [str(v) for v in s.domain],
            "selectors": {k: [str(v) for v in p]
                          for k, p in sorted(s.selector_polys.items())},
            "sigmas": [[str(v) for v in p] for p in s.sigma_polys],
            "l1": [str(v) for v in s.l1_poly],
            "selector_commits": {k: aff(p) for k, p in
                                 sorted(s.selector_commits.items())},
            "sigma_commits": [aff(p) for p in s.sigma_commits]}


@pytest.fixture(scope="module")
def port():
    c, assign = mult_circuit(tp)
    prover = tp.PlonkProver(rng_seed=3, device="cpu")
    setup = prover.setup(c, kzg_seed=1)
    proof = prover.prove(setup, assign, [42])
    return setup, proof


def test_proof_matches_committed_jax_vector(port):
    _, proof = port
    with open(VECTORS) as fh:
        assert proof_values(proof) == json.load(fh)["plonk_mult"]["proof"]


def test_setup_matches_jax_live(port):
    """The setup (interpolated selectors, permutation, L1, their KZG
    commitments) equals the JAX package's, live and carried across."""
    setup, _ = port
    c, _ = mult_circuit(jp)
    jsetup = jp.PlonkProver(rng_seed=3).setup(c, kzg_seed=1)
    carried = convert.plonk_setup_from_jax(jsetup, "cpu")
    assert setup_values(carried) == setup_values(setup)
    assert carried.sigma_tags == setup.sigma_tags
    assert [g.__dict__ for g in carried.circuit.gates] == \
        [g.__dict__ for g in setup.circuit.gates]


def test_verify_and_refuse(port):
    setup, proof = port
    v = tp.PlonkVerifier("cpu")
    assert v.verify(setup, [42], proof)
    assert not v.verify(setup, [43], proof)
    bad = tp.PlonkProof(commits=dict(proof.commits), evals=dict(proof.evals))
    bad.evals["a"] = (bad.evals["a"] + 1) % tp.R
    assert not v.verify(setup, [42], bad)
    bad = tp.PlonkProof(commits=dict(proof.commits), evals={
        k: v for k, v in proof.evals.items() if k != "z_w"})
    assert not v.verify(setup, [42], bad)


def test_verifiers_accept_each_others_proofs(port):
    """The port verifies the JAX proof (committed, carried across) against
    a carried JAX setup; the JAX verifier accepts the port's proof."""
    setup, proof = port
    with open(VECTORS) as fh:
        vec = json.load(fh)["plonk_mult"]["proof"]
    jproof = jp.PlonkProof(
        commits={k: (int(v[0]), int(v[1]), bool(v[2]))
                 for k, v in vec["commits"].items()},
        evals={k: int(v) for k, v in vec["evals"].items()})
    c, _ = mult_circuit(jp)
    jsetup = jp.PlonkProver(rng_seed=3).setup(c, kzg_seed=1)
    carried = convert.plonk_setup_from_jax(jsetup, "cpu")
    assert tp.PlonkVerifier("cpu").verify(
        carried, [42], convert.plonk_proof_from_jax(jproof))
    jv = jp.PlonkVerifier()
    assert jv.verify(jsetup, [42], jp.PlonkProof(commits=proof.commits,
                                                 evals=proof.evals))
    assert not jv.verify(jsetup, [41], jp.PlonkProof(commits=proof.commits,
                                                     evals=proof.evals))


def test_prove_refuses_a_bad_witness(port):
    setup, _ = port
    c = setup.circuit
    z, x, y, xy = 1, 2, 3, 4
    with pytest.raises(ValueError, match="unsatisfied"):
        tp.PlonkProver(rng_seed=1, device="cpu").prove(
            setup, {z: 42, x: 6, y: 7, xy: 41}, [42])
    assert len(c.gates) == 3


def test_tally_circuit_matches_jax_and_proves():
    """tally_correctness_circuit(8): the JAX package's gates; a port proof
    of a total over 8 ballots (n = 16, the quotient on 128 points)
    verifies and a wrong total is refused."""
    tc, tb, tt = tp.tally_correctness_circuit(8)
    jc, jb, jt = jp.tally_correctness_circuit(8)
    assert [g.__dict__ for g in tc.gates] == [g.__dict__ for g in jc.gates]
    assert (tb, tt, tc.public_gates) == (jb, jt, jc.public_gates)
    from node_fhe_accelerate_tpu_torch.api.zk import ZKProofManager
    mgr = ZKProofManager(range_bits=4, device="cpu")
    mgr.init_tally(8)
    vals = [1, 0, 2, 3, 1, 1, 0, 2]
    p = mgr.prove_tally_correctness(vals, sum(vals))
    assert mgr.verify_tally_correctness(p).valid
    p.total += 1
    assert not mgr.verify_tally_correctness(p).valid


def test_domain_cache_is_keyed_by_size_and_device():
    a = tp._get_domain(8, "cpu")
    assert tp._get_domain(8, "cpu") is a
    assert tp._get_domain(16, "cpu") is not a
    assert (8, "cpu") in tp._DOMAINS


@pytest.mark.slow
def test_proof_matches_jax_live(port):
    """The JAX package's seeded proof, now: equal to the port's and to the
    committed vector."""
    _, proof = port
    c, assign = mult_circuit(jp)
    prover = jp.PlonkProver(rng_seed=3)
    jsetup = prover.setup(c, kzg_seed=1)
    jproof = prover.prove(jsetup, assign, [42])
    assert proof_values(jproof) == proof_values(proof)
    with open(VECTORS) as fh:
        assert proof_values(jproof) == json.load(fh)["plonk_mult"]["proof"]
