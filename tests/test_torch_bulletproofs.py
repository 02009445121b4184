"""The port's ZK hashes and Bulletproofs (node_fhe_accelerate_tpu_torch/
zk/hashes.py, rand.py, bulletproofs.py) against the JAX package, on the CPU.

The JAX prover takes minutes on the CPU, so the default tier compares the
4-bit range proof field for field against the proof the JAX package made
with the same seed and value, committed below; the ``slow`` tier makes that
proof with the JAX package live and holds both the port's proof and the
committed one equal to it:

    curve = bn254_g1(); gens = BulletproofsGens.generate(curve, 4)
    prover = BulletproofsProver(curve, rng_seed=7)
    blinding = prover.random_scalar()
    V = prover.commit(12, blinding, gens).point
    proof = prover.prove_range(12, blinding, 4, gens)

(affine ints (x, y, is_infinity) for the points).  The Poseidon vectors are
the JAX package's, from tests/test_golden_vectors.py.  Tolerance: exact
equality."""
import numpy as np
import pytest

from node_fhe_accelerate_tpu.zk import bulletproofs as jbp
from node_fhe_accelerate_tpu.zk import hashes as jhashes
from node_fhe_accelerate_tpu.zk.curve import bn254_g1 as jax_bn254_g1
from node_fhe_accelerate_tpu.zk.rand import ScalarRng as JaxScalarRng
from node_fhe_accelerate_tpu_torch.convert import (
    bulletproofs_gens_from_numpy, points_to_numpy)
from node_fhe_accelerate_tpu_torch.zk import bulletproofs as bp
from node_fhe_accelerate_tpu_torch.zk import hashes
from node_fhe_accelerate_tpu_torch.zk.curve import bn254_g1
from node_fhe_accelerate_tpu_torch.zk.rand import ScalarRng

JAX_PROOF_4 = {
    "blinding": 13983849906569549582936910300946112256120123649754930664455160903738812911147,
    "V": (4359310326014427708847952290450875404830129123816558319304509372815829016091,
          11115010767376608612749518259989041018316696377797604963810073313292661021893,
          False),
    "A": (1207215941007900337251948999056725523465404930027208377853521864884148268363,
          15558676764490100578796383144529859237798546641898591303289315484982738221090,
          False),
    "S": (21336046000235987699472568316305834324866772756509250054715986629270981810483,
          8801560019541642194734446543318138031849374332679639755015998169903269853438,
          False),
    "T1": (17519574494475662426881176605338208664362114218101760137797807784927032913133,
           21577702263451325167119211719515930715623298159127949790263441142810090539277,
           False),
    "T2": (10695459867689323960772876546707888289568951166490961292099576653898318525827,
           17183663477501573693253872090025032293694120971390217891354818504845854208852,
           False),
    "t_hat": 8292466736793481834465249394370233559762956190790880816665405515097614688862,
    "tau_x": 8386958405641121072616092844566158609626720290019525865314883004102188891559,
    "mu": 7482552219963835388530827146166707084205657745724859748204322174553822745440,
    "L": [(21293915197081685752918838955857879365526826735852723078322210701738288145957,
           21357158078746322513305047020620657301988298380307156006486848525710692999277,
           False),
          (1191617629160990178013539724987246756315535697541509193010916495731389272209,
           8800352039369007656218088904198072775612413452012649536115309663070977605736,
           False)],
    "R": [(953076782193859651145859526181491578946170555448161189192172737791740417114,
           10501796062891975739483933526706338995466962737161960106438659912720121765551,
           False),
          (12540701141307505948117622466023318549996263698446565984995063472858521757906,
           11041753036046962274875529324739978845003235604177467747227104204102759136009,
           False)],
    "a": 12615416161088963419340315933970764669089363330983069703139428524166108222192,
    "b": 16726102037585342811349054081331135410640957325727959843597322062787484542564,
}

# tests/test_golden_vectors.py (made by the JAX package's PoseidonHash)
GOLDEN_POSEIDON = {
    (1,): 0x28c8e0346230df0b1332cabf23cd8e12da3e4c0572d9356390a2e4624757d3e8,
    (1, 2): 0x3fc16de2dd45833348e22bc18de0e5f9c12d7f4203ee19f0c34c15229db9082,
    (1, 2, 3, 4, 5):
        0x26cafb1310f69e2b8767092af1f56ef45cd44a2f7142d6eae2fc4f2cc3332a56,
}


def test_scalar_rng_matches_jax():
    r = bn254_g1(device="cpu").order
    assert ScalarRng(r, 7).scalars(5) == JaxScalarRng(r, 7).scalars(5)
    assert ScalarRng(r, 7).deterministic and not ScalarRng(r).deterministic
    with pytest.raises(ValueError):
        ScalarRng(1)


def test_transcript_and_blake2s_match_jax():
    runs = []
    for mod in (hashes, jhashes):
        t = mod.Transcript("test-proto")
        t.append_u64("n", 42)
        t.append_field_element("x", 1234567890123456789)
        t.append_point("P", (3, 17, False))
        t.append_point("O", (0, 0, True))
        out = [t.challenge_bytes("alpha"),
               t.challenge_field_element("beta", 1 << 61),
               t.fork("branch").challenge_bytes("gamma"),
               mod.Blake2sHash.hash(b"node-fhe-accelerate"),
               mod.Blake2sHash.to_field_element(b"\x01\x02", 97)]
        runs.append(out)
    assert runs[0] == runs[1]


def test_poseidon_matches_jax_vectors():
    p = hashes.PoseidonHash(device="cpu")
    jp = jhashes.PoseidonHash()
    assert p.round_constants_int == jp.round_constants_int
    assert p.mds_int == jp.mds_int
    np.testing.assert_array_equal(p.round_constants.numpy(),
                                  np.asarray(jp.round_constants))
    for ins in ((1,), (1, 2, 3, 4, 5)):
        assert p.hash_ints(ins) == GOLDEN_POSEIDON[ins], ins
    # a Merkle tree of two leaves: its root is hash2 of them, and a path
    # verifies only its own leaf
    leaves = p.f.encode([1, 2])
    tree = hashes.MerkleTree(p, leaves)
    assert int(p.f.decode(tree.root)) == GOLDEN_POSEIDON[(1, 2)]
    assert tree.verify(leaves[1], 1, tree.path(1), tree.root)
    assert not tree.verify(leaves[0], 1, tree.path(1), tree.root)


@pytest.fixture(scope="module")
def bp4():
    curve = bn254_g1(device="cpu")
    gens = bp.BulletproofsGens.generate(curve, 4)
    return curve, gens


def test_generators_match_jax(bp4):
    curve, gens = bp4
    jg = jbp.BulletproofsGens.generate(jax_bn254_g1(), 4)
    carried = bulletproofs_gens_from_numpy(
        curve, *[[np.asarray(c) for c in p]
                 for p in (jg.G, jg.H, jg.U, jg.g_vec, jg.h_vec)], n=jg.n)
    for ours in (gens, carried):
        for name in ("G", "H", "U", "g_vec", "h_vec"):
            for g, w in zip(points_to_numpy(getattr(ours, name)),
                            getattr(jg, name)):
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert bp.hash_to_curve(b"x", curve) == jbp.hash_to_curve(
        b"x", jax_bn254_g1())


def test_range_proof_4_bits_matches_jax(bp4):
    curve, gens = bp4
    prover = bp.BulletproofsProver(curve, rng_seed=7)
    want = JAX_PROOF_4
    blinding = prover.random_scalar()
    assert blinding == want["blinding"]
    com = prover.commit(12, blinding, gens)
    assert bp._aff(curve, com.point) == want["V"]
    proof = prover.prove_range(12, blinding, 4, gens)
    for k in ("A", "S", "T1", "T2", "t_hat", "tau_x", "mu"):
        assert getattr(proof, k) == want[k], k
    assert proof.inner.L == want["L"] and proof.inner.R == want["R"]
    assert (proof.inner.a, proof.inner.b) == (want["a"], want["b"])

    verifier = bp.BulletproofsVerifier(curve)
    assert verifier.verify_range(com, proof, 4, gens)
    proof.t_hat = (proof.t_hat + 1) % curve.order
    assert not verifier.verify_range(com, proof, 4, gens)
    proof.t_hat = want["t_hat"]
    other = prover.commit(11, blinding, gens)
    assert not verifier.verify_range(other, proof, 4, gens)
    with pytest.raises(ValueError, match="out of range"):
        prover.prove_range(16, blinding, 4, gens)


@pytest.mark.slow
def test_range_proof_4_bits_matches_jax_live(bp4):
    curve, gens = bp4
    jc = jax_bn254_g1()
    jgens = jbp.BulletproofsGens.generate(jc, 4)
    jprover = jbp.BulletproofsProver(jc, rng_seed=7)
    prover = bp.BulletproofsProver(curve, rng_seed=7)
    blinding = jprover.random_scalar()
    assert prover.random_scalar() == blinding == JAX_PROOF_4["blinding"]
    want_v = jbp._aff(jc, jprover.commit(12, blinding, jgens).point)
    assert bp._aff(curve, prover.commit(12, blinding, gens).point) == want_v
    assert want_v == JAX_PROOF_4["V"]
    want = jprover.prove_range(12, blinding, 4, jgens)
    got = prover.prove_range(12, blinding, 4, gens)
    for k in ("A", "S", "T1", "T2", "t_hat", "tau_x", "mu"):
        assert getattr(got, k) == getattr(want, k) == JAX_PROOF_4[k], k
    for k in ("L", "R", "a", "b"):
        assert (getattr(got.inner, k) == getattr(want.inner, k)
                == JAX_PROOF_4[k]), k
