"""The port's election API (node_fhe_accelerate_tpu_torch/api/voting.py,
zk.py, verify.py and cli.py) against the JAX package's, on the CPU.

* ``VotingSystem`` with ``eligibility_snark=True``, two voters (tree depth
  1): ballots with Groth16 eligibility proofs that verify, a second ballot
  of one voter refused by its nullifier, swapped publics and a swapped
  proof refused, the tally decrypted 2-of-3 to the votes;
* ``VerificationPackage.to_json`` writes the same bytes as the JAX
  package's for the same objects (the eligibility proofs and key of the
  election above, and the 4-bit range proof the JAX package made in
  tests/test_torch_bulletproofs.py), reads back, and re-verifies through
  ``PublicVerifier``; the JAX package's ``PublicVerifier`` accepts the
  port's package, and a flipped proof digit fails both;
* the CLI: ``verify`` exits 0 on a good package and 1 on a tampered one,
  ``export-demo`` writes a package that verifies;
* ``ZKProofManager``: eligibility and tally proofs, the camelCase aliases.

The election's secrets come from ``secrets.randbits`` as in the JAX
package, so the checks are outcomes (the proofs themselves are held bit
for bit in tests/test_torch_groth16.py).  The ballot range proofs take
~20 s each on the CPU: the full ballot flow with them is ``slow``.
Tolerance: exact equality."""
import json
from types import SimpleNamespace

import pytest

from node_fhe_accelerate_tpu.api import verify as jverify
from node_fhe_accelerate_tpu.api import voting as jvoting
from node_fhe_accelerate_tpu.zk import bulletproofs as jbp
from node_fhe_accelerate_tpu.zk import groth16 as jg
from node_fhe_accelerate_tpu.zk import pairing as jpr
from node_fhe_accelerate_tpu_torch import cli
from node_fhe_accelerate_tpu_torch.api import verify as tverify
from node_fhe_accelerate_tpu_torch.api.voting import (ElectionState,
                                                       VotingSystem)
from node_fhe_accelerate_tpu_torch.api.zk import ZKProofManager
from node_fhe_accelerate_tpu_torch.convert import points_to_numpy
from node_fhe_accelerate_tpu_torch.zk import bulletproofs as tbp
from node_fhe_accelerate_tpu_torch.zk import groth16 as tg
from node_fhe_accelerate_tpu_torch.zk.curve import bn254_g1

VOTES = {"alice": 1, "bob": 0}


@pytest.fixture(scope="module")
def election():
    vs = VotingSystem("esnark", 2, threshold=(2, 3), enable_zk=False,
                      eligibility_snark=True, device="cpu")
    for v in VOTES:
        vs.register_voter(v)
    vs.start_election()
    ballots = {v: vs.submit_ballot(v, c) for v, c in VOTES.items()}
    return vs, ballots


def elig_ok(vs, b) -> bool:
    return vs._elig_verifier.verify(vs._elig_setup, b.eligibility_publics,
                                    b.eligibility_proof)


def test_eligibility_proofs_verify_and_tampering_is_refused(election):
    vs, ballots = election
    assert vs._elig_circuit.depth == 1
    for b in ballots.values():
        assert b.eligibility_proof is not None
        assert elig_ok(vs, b)
        assert vs.verify_ballot(b)           # nullifier known (no range)
    with pytest.raises(ValueError, match="nullifier"):
        vs.submit_ballot("alice", 0)
    with pytest.raises(ValueError, match="not registered"):
        vs.submit_ballot("mallory", 0)
    b = ballots["alice"]
    good_pubs, good = b.eligibility_publics, b.eligibility_proof
    b.eligibility_publics = [good_pubs[0] + 1, good_pubs[1]]
    assert not elig_ok(vs, b)
    b.eligibility_publics = good_pubs
    b.eligibility_proof = tg.Groth16Proof(a=good.c, b=good.b, c=good.a)
    assert not elig_ok(vs, b)
    b.eligibility_proof = good
    assert elig_ok(vs, b)


def test_secret_voter_identity_matches_jax(election):
    """vid = Blake2s(voter_id || secret) reduced into Fr, as the JAX
    package derives it."""
    vs, _ = election
    host = SimpleNamespace(_voters=dict(vs._voters))
    for v in VOTES:
        assert vs._vid(v) == jvoting.VotingSystem._vid(host, v)


def jax_g2(p):
    return None if p is None else tuple(jpr.FQ2(list(c.coeffs)) for c in p)


def jax_points(p):
    import jax.numpy as jnp
    return tuple(jnp.asarray(c) for c in points_to_numpy(p))


def jax_package(pkg):
    """The JAX package's VerificationPackage over the same objects."""
    ballots = []
    for b in pkg.ballots:
        com = proof = None
        if b.validity_proof is not None:
            p = b.validity_proof
            com = jbp.PedersenCommitment(point=jax_points(
                b.validity_commitment.point))
            proof = jbp.RangeProof(
                A=p.A, S=p.S, T1=p.T1, T2=p.T2, t_hat=p.t_hat, tau_x=p.tau_x,
                mu=p.mu, inner=jbp.InnerProductProof(
                    L=p.inner.L, R=p.inner.R, a=p.inner.a, b=p.inner.b))
        ep = b.eligibility_proof
        ballots.append(SimpleNamespace(
            ballot_id=b.ballot_id, nullifier=b.nullifier,
            timestamp=b.timestamp, validity_commitment=com,
            validity_proof=proof,
            eligibility_proof=None if ep is None else jg.Groth16Proof(
                a=ep.a, b=jax_g2(ep.b), c=ep.c),
            eligibility_publics=b.eligibility_publics))
    vk = pkg.elig_vk
    jvk = None if vk is None else SimpleNamespace(
        r1cs=SimpleNamespace(num_public=vk.r1cs.num_public),
        alpha_g1=jax_points(vk.alpha_g1), beta_g2=jax_g2(vk.beta_g2),
        gamma_g2=jax_g2(vk.gamma_g2), delta_g2=jax_g2(vk.delta_g2),
        ic=jax_points(vk.ic))
    return jverify.VerificationPackage(
        election_id=pkg.election_id, num_candidates=pkg.num_candidates,
        ballots=ballots, audit_json=pkg.audit_json,
        decrypted_tally=pkg.decrypted_tally, range_bits=pkg.range_bits,
        elig_vk=jvk, tree_root=pkg.tree_root)


def range_proof_ballot():
    """A ballot carrying the 4-bit range proof the JAX package made
    (tests/test_torch_bulletproofs.py JAX_PROOF_4, value 12)."""
    from test_torch_bulletproofs import JAX_PROOF_4 as P
    curve = bn254_g1("cpu")
    com = tbp.PedersenCommitment(point=curve.from_affine_ints(
        [P["V"][0]], [P["V"][1]]))
    proof = tbp.RangeProof(
        A=P["A"], S=P["S"], T1=P["T1"], T2=P["T2"], t_hat=P["t_hat"],
        tau_x=P["tau_x"], mu=P["mu"], inner=tbp.InnerProductProof(
            L=P["L"], R=P["R"], a=P["a"], b=P["b"]))
    return SimpleNamespace(ballot_id="rp-0", nullifier=99, timestamp=1.5,
                           validity_commitment=com, validity_proof=proof,
                           eligibility_proof=None, eligibility_publics=None)


@pytest.fixture(scope="module")
def package(election):
    vs, _ = election
    if vs.state == ElectionState.ACTIVE:
        vs.end_election()
        counts = vs.decrypt_tally([1, 3])
        assert [int(c) for c in counts] == [1, 1]
    return tverify.VerificationPackage.from_voting_system(vs)


def test_package_json_is_byte_identical_to_jax(package):
    raw = package.to_json()
    assert raw == jax_package(package).to_json()
    d = json.loads(raw)
    assert d["decryptedTally"] == [1, 1] and d["eligibilityVk"]
    # with a range proof aboard (4 bits)
    pkg = tverify.VerificationPackage(
        election_id="rp", num_candidates=2, ballots=[range_proof_ballot()],
        audit_json="[]", range_bits=4)
    assert pkg.to_json() == jax_package(pkg).to_json()


def test_package_reverifies_in_both_packages(package, tmp_path):
    raw = package.to_json()
    back = tverify.VerificationPackage.from_json(raw, device="cpu")
    seen = []
    res = tverify.PublicVerifier(
        progress=lambda i, n, s: seen.append((i, n)),
        device="cpu").verify_all(back)
    assert res.valid and res.ballots_valid == 2 and res.audit_valid
    assert seen[-1] == (2, 2)
    assert back.to_json() == raw
    jres = jverify.PublicVerifier().verify_all(
        jverify.VerificationPackage.from_json(raw))
    assert jres.valid and jres.ballots_valid == 2
    rep = json.loads(tverify.PublicVerifier.json_report(back, res))
    assert rep["valid"] and rep["ballotsChecked"] == 2
    assert "VALID" in tverify.PublicVerifier.html_report(back, res)
    # one flipped digit of a proof fails both verifiers
    d = json.loads(raw)
    x = d["ballots"][0]["eligibility"]["c"][0]
    d["ballots"][0]["eligibility"]["c"][0] = x[:-1] + str((int(x[-1]) + 1)
                                                          % 10)
    bad = json.dumps(d)
    assert not tverify.PublicVerifier(device="cpu").verify_all(
        tverify.VerificationPackage.from_json(bad, device="cpu")).valid
    assert not jverify.PublicVerifier().verify_all(
        jverify.VerificationPackage.from_json(bad)).valid


def test_range_proof_package_reverifies():
    """The JAX package's 4-bit range proof, exported by the port, read
    back and verified with regenerated generators; t_hat tampered fails."""
    pkg = tverify.VerificationPackage(
        election_id="rp", num_candidates=2, ballots=[range_proof_ballot()],
        audit_json="[]", range_bits=4)
    raw = pkg.to_json()
    v = tverify.PublicVerifier(device="cpu")
    res = v.verify_all(tverify.VerificationPackage.from_json(raw, "cpu"))
    assert res.ballots_valid == 1 and res.nullifiers_unique
    d = json.loads(raw)
    d["ballots"][0]["range_proof"]["t_hat"] = str(
        int(d["ballots"][0]["range_proof"]["t_hat"]) + 1)
    res = v.verify_all(tverify.VerificationPackage.from_json(json.dumps(d),
                                                             "cpu"))
    assert res.ballots_valid == 0 and not res.valid


def test_cli_verify_and_reports(package, tmp_path, capsys):
    good = tmp_path / "pkg.json"
    good.write_text(package.to_json())
    rep_json, rep_html = tmp_path / "r.json", tmp_path / "r.html"
    assert cli.main(["verify", str(good), "--quiet", "--device", "cpu",
                     "--json", str(rep_json), "--html", str(rep_html)]) == 0
    assert "election esnark: VALID" in capsys.readouterr().out
    assert json.loads(rep_json.read_text())["valid"] is True
    assert "<html" in rep_html.read_text()
    d = json.loads(good.read_text())
    d["decryptedTally"][0] += 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(d))
    assert cli.main(["verify", str(bad), "--quiet", "--device", "cpu"]) == 1
    assert "INVALID" in capsys.readouterr().out


def test_cli_export_demo_then_verify(tmp_path, capsys):
    out = tmp_path / "demo.json"
    assert cli.main(["export-demo", str(out), "--device", "cpu"]) == 0
    d = json.loads(out.read_text())
    assert d["decryptedTally"] == [2, 2] and len(d["ballots"]) == 4
    assert cli.main(["verify", str(out), "--quiet", "--device", "cpu"]) == 0
    assert "VALID" in capsys.readouterr().out


def test_zk_proof_manager_eligibility_and_aliases():
    mgr = ZKProofManager(range_bits=4, device="cpu")
    assert mgr.getProofSystem("eligibility")["system"] == "groth16"
    with pytest.raises(ValueError):
        mgr.get_proof_system("nope")
    with pytest.raises(RuntimeError):
        mgr.prove_eligibility(1, 2)
    root = mgr.init_eligibility([11, 22])
    assert mgr.tree_depth == 1 and root == mgr._elig[6]
    p = mgr.proveEligibility(22, mgr.get_voter_secret(22))
    assert mgr.verifyEligibility(p).valid
    p.public_inputs = [p.public_inputs[0], p.public_inputs[1] + 1]
    res = mgr.verify_eligibility(p)
    assert not res.valid and res.error == "pairing check failed"
    for camel in ("proveBallotValidity", "batchVerify",
                  "proveTallyCorrectness", "verifyTallyCorrectness"):
        assert getattr(ZKProofManager, camel) is getattr(
            ZKProofManager, {"proveBallotValidity": "prove_ballot_validity",
                             "batchVerify": "batch_verify_ballots",
                             "proveTallyCorrectness":
                                 "prove_tally_correctness",
                             "verifyTallyCorrectness":
                                 "verify_tally_correctness"}[camel])


@pytest.mark.slow
def test_full_ballot_flow_with_range_proofs():
    """Ballots with both proofs (4-bit range proofs on the CPU), as the
    JAX package's tests/test_voting.py runs its own."""
    VotingSystem.RANGE_BITS = 4
    try:
        vs = VotingSystem("ezk", 2, threshold=(2, 3), enable_zk=True,
                          eligibility_snark=True, device="cpu")
        vs.register_voter("alice")
        vs.register_voter("bob")
        vs.start_election()
        b = vs.submit_ballot("alice", 1)
        assert vs.verify_ballot(b)
        pubs = b.eligibility_publics
        b.eligibility_publics = [pubs[0] + 1, pubs[1]]
        assert not vs.verify_ballot(b)
        b.eligibility_publics = pubs
        b.validity_proof.t_hat = (b.validity_proof.t_hat + 1) % (1 << 200)
        assert not vs.verify_ballot(b)
        mgr = ZKProofManager(range_bits=4, device="cpu")
        vp = mgr.prove_ballot_validity(1, 2)
        assert mgr.verify_ballot_validity(vp).valid
        assert [r.valid for r in mgr.batchVerify([vp])] == [True]
    finally:
        VotingSystem.RANGE_BITS = 8


def test_jax_pairing_types_stay_apart():
    """A proof from JSON carries the port's FQ2, which the port's pairing
    takes; the JAX package's FQ2 is another class."""
    from node_fhe_accelerate_tpu_torch.zk import pairing as tpr
    q = tverify._ung2aff([["1", "2"], ["3", "4"]])
    assert isinstance(q[0], tpr.FQ2) and not isinstance(q[0], jpr.FQ2)
