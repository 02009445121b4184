"""The port's public API (api/engine.py FHEEngine, api/context.py
FHEContext, api/ckks_context.py CkksContext, api/tally.py, api/audit.py,
api/fraud.py) against the JAX package on the CPU.

The engine runs over the three-prime chain of tests/test_rns.py (N=64,
30/30/29 bits, t=64) with the JAX engine's keys and ciphertexts carried
across (convert.py): every result is compared with the JAX engine's, bit
for bit, and serialized blobs byte for byte.  The JAX RNS multiply compiles
for ~95 s on the CPU, so ``multiply_relin`` and ``CkksContext.dot`` are
held against SHA-256 digests of the JAX package's outputs on the same
inputs (committed below), which the ``slow`` tests ``*_live`` compute now:

    pytest -m slow -k live -n 0 tests/test_torch_api.py

The contexts also run on the port's own generator (keys, encryption,
products, threshold decryption, a bootstrap) and must decrypt to the
messages; the CKKS values within tests/test_ckks.py's tolerances."""
import dataclasses
import hashlib
import json

import jax
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.api import audit as jaudit
from node_fhe_accelerate_tpu.api import engine as jengine
from node_fhe_accelerate_tpu.api import fraud as jfraud
from node_fhe_accelerate_tpu.api import tally as jtally
from node_fhe_accelerate_tpu.api.ckks_context import (
    CkksContext as JaxCkksContext)
from node_fhe_accelerate_tpu.core import ckks as jckks
from node_fhe_accelerate_tpu.core import params as jparams
from node_fhe_accelerate_tpu.core.encrypt import (
    Ciphertext as JaxCiphertext, EncryptionEngine as JaxEncryptionEngine)
from node_fhe_accelerate_tpu.ops.u64 import u64_from_np as jax_from_np
from node_fhe_accelerate_tpu_torch.api import audit, engine, fraud, tally
from node_fhe_accelerate_tpu_torch.api.ckks_context import CkksContext
from node_fhe_accelerate_tpu_torch.api.context import FHEContext
from node_fhe_accelerate_tpu_torch.convert import (
    ckks_ciphertext_to_numpy, rns_poly_from_numpy, rns_poly_to_numpy,
    rns_relin_key_from_numpy)
from node_fhe_accelerate_tpu_torch.core import params
from node_fhe_accelerate_tpu_torch.core.bootstrap import TfheParams
from node_fhe_accelerate_tpu_torch.core.encrypt import (Ciphertext,
                                                        EncryptionEngine)
from node_fhe_accelerate_tpu_torch.core.keys import PublicKey, SecretKey
from node_fhe_accelerate_tpu_torch.core.rns import RnsEncryptionEngine
from node_fhe_accelerate_tpu_torch.core.threshold import (SecretKeyShare,
                                                          ThresholdKeys)
from node_fhe_accelerate_tpu_torch.ops.primes import find_ntt_prime
from node_fhe_accelerate_tpu_torch.ops.u64 import u64_from_np

torch.set_num_threads(2)

N = 64
Q1 = find_ntt_prime(30, N)
Q2 = find_ntt_prime(30, N, below=Q1)
Q3 = find_ntt_prime(29, N)
T = 64
SCALE = 1 << 26
# SHA-256 of the JAX package's outputs on the inputs below
DIGESTS = {
    "multiply_relin":
        "773fa7686f3cd972b58f1a6a4f8ea0b169cbc46ea6f6d66c4dbdb7740ea251e7",
    "dot":
        "8332e961a7537910e3a62a5b676c78456fefde7393ea6199d92cbece32405c5f",
}


def kwargs(scheme_t=T):
    return dict(poly_degree=N, moduli=[Q1, Q2, Q3], lwe_dimension=16,
                lwe_noise_std=3.2e-11, glwe_dimension=1, decomp_base_log=8,
                decomp_level=4, plaintext_modulus=scheme_t)


def np_rns(poly):
    return tuple(tuple(np.asarray(x) for x in r) for r in poly)


def port(poly):
    return rns_poly_from_numpy(np_rns(poly), "cpu")


def port_ct(jct):
    return Ciphertext(c0=port(jct.c0), c1=port(jct.c1),
                      c2=None if jct.c2 is None else port(jct.c2),
                      noise_budget=jct.noise_budget, key_id=jct.key_id)


def rns_bytes(poly) -> bytes:
    out = b""
    for lo, hi in (rns_poly_to_numpy(poly) if isinstance(poly[0][0],
                                                         torch.Tensor)
                   else np_rns(poly)):
        lo, hi = (v.view(np.uint32).astype(np.uint64) for v in (lo, hi))
        out += np.ascontiguousarray(lo | (hi << np.uint64(32)),
                                    dtype="<u8").tobytes()
    return out


def digest(ct) -> str:
    """SHA-256 of a BFV or CKKS ciphertext: residues, then the noise
    budget or the level and scale."""
    h = hashlib.sha256()
    for poly in (ct.c0, ct.c1, ct.c2):
        if poly is not None:
            h.update(rns_bytes(poly))
    if hasattr(ct, "level"):
        h.update(f"{ct.level} {ct.scale}".encode())
    else:
        h.update(repr(float(ct.noise_budget)).encode())
    return h.hexdigest()


def assert_ct(got, want):
    assert digest(got) == digest(want)
    assert got.key_id == want.key_id


@pytest.fixture(scope="module")
def s():
    """The JAX FHEEngine's keys and ciphertexts over the chain (its own
    generator chain from rng_seed 0) and the port's FHEEngine holding
    them."""
    jp = jparams.ParameterSet(scheme=jparams.FHEScheme.BFV, **kwargs())
    p = params.ParameterSet(scheme=params.FHEScheme.BFV, **kwargs())
    jfhe = jengine.FHEEngine(jp)
    fhe = engine.FHEEngine(p, device="cpu")
    jsk = jfhe.generate_secret_key()
    jpk = jfhe.generate_public_key(jsk)
    jek = jfhe.generate_eval_key(jsk)
    jcts = [jfhe.encrypt_value(7, jpk), jfhe.encrypt_packed([6, 5], jpk),
            jfhe.encrypt_value(63, jpk)]
    sk = SecretKey(poly=port(jsk.poly), key_id=jsk.key_id)
    pk = PublicKey(a=port(jpk.a), b=port(jpk.b), key_id=jpk.key_id)
    ek = rns_relin_key_from_numpy([np_rns(x) for x in jek.a],
                                  [np_rns(x) for x in jek.b], device="cpu")
    return dict(jfhe=jfhe, fhe=fhe, jsk=jsk, jpk=jpk, jek=jek, jcts=jcts,
                sk=sk, pk=pk, ek=ek, cts=[port_ct(c) for c in jcts])


# ---------------------------------------------------------------------------
# FHEEngine over the chain
# ---------------------------------------------------------------------------


def test_engine_selects_the_rns_engine(s):
    fhe = s["fhe"]
    assert isinstance(fhe.engine, RnsEncryptionEngine)
    assert fhe.ring.K == 3 and fhe.device.type == "cpu"
    assert fhe.tfhe.device.type == "cpu" and fhe.tfhe.backend == "mxu"
    assert fhe.get_slot_count() == N
    single = engine.create_fhe_engine("TFHE_128_FAST", device="cpu")
    assert not isinstance(single.engine, RnsEncryptionEngine)


def test_camel_aliases_match_jax():
    assert engine._CAMEL_ALIASES == jengine._CAMEL_ALIASES
    for camel, snake in engine._CAMEL_ALIASES.items():
        assert getattr(engine.FHEEngine, camel) is \
            getattr(engine.FHEEngine, snake)


def test_hardware_capabilities_read_torch():
    hw = engine.HardwareCapabilities.detect()
    assert [f.name for f in dataclasses.fields(hw)] == \
        [f.name for f in dataclasses.fields(jengine.HardwareCapabilities)]
    assert hw.has_tpu is False
    if not torch.cuda.is_available():
        assert (hw.platform, hw.device_count) == ("cpu", 1)


def test_keys_carried_across_decrypt_as_in_jax(s):
    fhe, jfhe = s["fhe"], s["jfhe"]
    for ct, jct, n in zip(s["cts"], s["jcts"], (1, 2, 1)):
        np.testing.assert_array_equal(
            fhe.decrypt_packed(ct, s["sk"], n),
            jfhe.decrypt_packed(jct, s["jsk"], n))
        assert fhe.get_noise_budget(ct, s["sk"]) == \
            jfhe.get_noise_budget(jct, s["jsk"])
        assert fhe.estimate_noise_budget(ct) == \
            jfhe.estimate_noise_budget(jct)
    assert fhe.decrypt_value(s["cts"][0], s["sk"]) == 7
    pt, budget = fhe.decrypt(s["cts"][1], s["sk"])
    jpt, jbudget = jfhe.decrypt(s["jcts"][1], s["jsk"])
    assert pt.value() == jpt.value() == 6 and budget == jbudget


def test_arithmetic_matches_jax(s):
    fhe, jfhe = s["fhe"], s["jfhe"]
    (a, b, c), (ja, jb, jc) = s["cts"], s["jcts"]
    pairs = [(fhe.add(a, b), jfhe.add(ja, jb)),
             (fhe.subtract(a, b), jfhe.subtract(ja, jb)),
             (fhe.negate(c), jfhe.negate(jc)),
             (fhe.add_scalar(a, 3), jfhe.add_scalar(ja, 3)),
             (fhe.add_plain(a, fhe.create_packed_plaintext([1, 2])),
              jfhe.add_plain(ja, jfhe.create_packed_plaintext([1, 2]))),
             (fhe.multiply_scalar(b, 4), jfhe.multiply_scalar(jb, 4)),
             (fhe.multiply_plain(b, fhe.create_plaintext(3)),
              jfhe.multiply_plain(jb, jfhe.create_plaintext(3))),
             (fhe.batch_add([a, b, c]), jfhe.batch_add([ja, jb, jc]))]
    for got, want in pairs:
        assert_ct(got, want)
    seen = []
    got = fhe.batch_add([a, b, c], progress=lambda *x: seen.append(x))
    assert_ct(got, jfhe.batch_add([ja, jb, jc]))
    assert seen == [(2, 3, "tallying"), (3, 3, "tallying")]
    assert fhe.decrypt_packed(pairs[0][0], s["sk"], 2).tolist() == [13, 5]
    assert fhe.decrypt_value(pairs[2][0], s["sk"]) == 1


def test_serialization_is_byte_identical_to_jax(s):
    fhe, jfhe = s["fhe"], s["jfhe"]
    for ct, jct in zip(s["cts"], s["jcts"]):
        raw = fhe.serialize_ciphertext(ct)
        assert raw == jfhe.serialize_ciphertext(jct)
        assert_ct(fhe.deserialize_ciphertext(raw),
                  jfhe.deserialize_ciphertext(raw))
    raw = fhe.serialize_secret_key(s["sk"])
    assert raw == jfhe.serialize_secret_key(s["jsk"])
    back = fhe.deserialize_secret_key(raw)
    assert rns_bytes(back.poly) == rns_bytes(s["jsk"].poly)
    raw = fhe.serialize_public_key(s["pk"])
    assert raw == jfhe.serialize_public_key(s["jpk"])
    back = fhe.deserialize_public_key(raw)
    assert rns_bytes(back.b) == rns_bytes(s["jpk"].b)
    assert fhe.decrypt_packed(fhe.deserialize_ciphertext(
        fhe.serialize_ciphertext(s["cts"][1])), s["sk"], 2).tolist() == [6, 5]


def test_threshold_decryption_matches_jax(s):
    fhe, jfhe = s["fhe"], s["jfhe"]
    jtk = jfhe.generate_threshold_keys(2, 3)
    jpk = jfhe.generate_public_key(jtk.master_sk)
    jct = jfhe.encrypt_value(23, jpk)
    tk = ThresholdKeys(
        threshold=2, total_shares=3,
        shares=[SecretKeyShare(share_id=x.share_id,
                               share_poly=port(x.share_poly))
                for x in jtk.shares],
        master_sk=SecretKey(poly=port(jtk.master_sk.poly)))
    ct = port_ct(jct)
    for pick in ((0, 1), (2, 0)):
        parts = [fhe.partial_decrypt(ct, tk.shares[i]) for i in pick]
        jparts = [jfhe.partial_decrypt(jct, jtk.shares[i]) for i in pick]
        for x, y in zip(parts, jparts):
            assert rns_bytes(x.partial) == rns_bytes(y.partial)
        pt = fhe.combine_partial_decryptions(ct, parts, 2)
        jpt = jfhe.combine_partial_decryptions(jct, jparts, 2)
        np.testing.assert_array_equal(pt.values, jpt.values)
        assert int(pt.values[0]) == 23
    with pytest.raises(ValueError):
        fhe.combine_partial_decryptions(ct, parts[:1], 2)


def test_multiply_relin_matches_jax_digest(s):
    fhe = s["fhe"]
    a, b, _ = s["cts"]
    m = fhe.multiply_relin(a, b, s["ek"])
    assert digest(m) == DIGESTS["multiply_relin"]
    assert fhe.decrypt_packed(m, s["sk"], 2).tolist() == [42, 35]
    sq = fhe.square_relin(a, s["ek"])
    assert fhe.decrypt_value(sq, s["sk"]) == 49
    assert_ct(fhe.relinearize(fhe.multiply(a, b), s["ek"]), m)


@pytest.mark.slow
def test_multiply_relin_matches_jax_live(s):
    ja, jb, _ = s["jcts"]
    want = s["jfhe"].multiply_relin(ja, jb, s["jek"])
    a, b, _ = s["cts"]
    assert_ct(s["fhe"].multiply_relin(a, b, s["ek"]), want)
    assert digest(want) == DIGESTS["multiply_relin"]


def test_engine_on_its_own_generator():
    """Keys, encryptions, a relinearized product, threshold keys and a
    bootstrap from the port engine's own generator on the CPU."""
    p = params.ParameterSet(scheme=params.FHEScheme.BFV, **kwargs())
    tp = TfheParams(n_lwe=8, poly_degree=256, glwe_dim=1, pbs_base_log=7,
                    pbs_level=3, ks_base_log=4, ks_level=8,
                    lwe_noise_std=0.0, glwe_noise_std=0.0,
                    plaintext_modulus=4)
    fhe = engine.create_fhe_engine(p, tfhe_params=tp, rng_seed=3,
                                   device="cpu")
    sk = fhe.generateSecretKey()
    pk = fhe.generate_public_key(sk)
    ek = fhe.generate_eval_key(sk)
    a, b = fhe.batch_encrypt([fhe.create_plaintext(5),
                              fhe.create_plaintext(9)], pk)
    assert fhe.decrypt_value(fhe.multiply_relin(a, b, ek), sk) == 45
    assert fhe.decrypt_value(fhe.get_zero_ciphertext(pk), sk) == 0
    lwe_sk, _, bsk = fhe.generate_bootstrap_key()
    lwe = fhe.tfhe.lwe_encrypt(fhe.gen, torch.tensor([0, 1, 1, 0]), lwe_sk)
    out = fhe.programmable_bootstrap(lwe, bsk, lambda v: (v + 1) % 2)
    assert fhe.tfhe.lwe_decrypt(out, lwe_sk).tolist() == [1, 0, 0, 1]
    many = fhe.bootstrap_many_lut(lwe, bsk, [lambda v: v, lambda v: 1 - v])
    assert fhe.tfhe.lwe_decrypt(many, lwe_sk).tolist() == \
        [[0, 1, 1, 0], [1, 0, 0, 1]]
    assert fhe.tfhe.lwe_decrypt(fhe.bootstrap(lwe, bsk),
                                lwe_sk).tolist() == [0, 1, 1, 0]
    assert fhe.validate_security().__class__.__name__ == "ValidationResult"
    assert fhe.get_params() is p


# ---------------------------------------------------------------------------
# the contexts
# ---------------------------------------------------------------------------


def test_fhe_context_over_the_chain():
    p = params.ParameterSet(scheme=params.FHEScheme.BFV, **kwargs())
    ctx = FHEContext(engine.FHEEngine(p, rng_seed=1, device="cpu"),
                     threshold_config=(2, 3))
    a, b = ctx.encrypt(7), ctx.encrypt([6, 2])
    assert ctx.decrypt(ctx.add(a, b)) == 13
    assert ctx.decrypt_packed(ctx.subtract(b, a), 2).tolist() == [63, 2]
    assert ctx.decrypt_packed(ctx.multiply(a, b), 2).tolist() == [42, 14]
    assert ctx.noise_budget(a) > 40
    assert len(ctx.threshold_keys.shares) == 3


def test_fhe_context_factories():
    fast = FHEContext.create_fast(device="cpu")
    assert fast.engine.params.poly_degree == 1024
    assert fast.decrypt(fast.add(fast.encrypt(1), fast.encrypt(2))) == 3
    voting = FHEContext.create_voting(device="cpu")
    tk = voting.threshold_keys
    assert (tk.threshold, tk.total_shares) == (3, 5)
    fhe = voting.engine
    ct = fhe.encrypt_value(11, fhe.generate_public_key(tk.master_sk))
    parts = [fhe.partial_decrypt(ct, tk.shares[i]) for i in (0, 2, 4)]
    assert int(fhe.combine_partial_decryptions(ct, parts, 3).values[0]) == 11
    for name in ("create_balanced", "create_secure", "create_simd",
                 "create_ml"):
        assert callable(getattr(FHEContext, name))


def ckks_context():
    p = params.ParameterSet(scheme=params.FHEScheme.CKKS, **kwargs(0))
    return CkksContext(p, scale=SCALE, rng_seed=2, device="cpu")


def test_ckks_context_round_trip_and_dot():
    ctx = ckks_context()
    a, b = ctx.encrypt([1.0, 2.0]), ctx.encrypt([0.5, -1.0])
    np.testing.assert_allclose(ctx.decrypt(ctx.add(a, b), 2), [1.5, 1.0],
                               atol=1e-4)
    np.testing.assert_allclose(ctx.decrypt(ctx.subtract(a, b), 2),
                               [0.5, 3.0], atol=1e-4)
    np.testing.assert_allclose(ctx.decrypt(ctx.add_plain(a, [1.0]), 1),
                               [2.0], atol=1e-4)
    m = ctx.multiply(a, b)
    assert m.level == 2 and ctx.levels_remaining == 3
    np.testing.assert_allclose(ctx.decrypt(m, 2), [0.5, -2.0], atol=1e-3)
    d = ctx.dot([a, b], [2.0, 4.0])
    assert digest(d) == DIGESTS["dot"]
    np.testing.assert_allclose(ctx.decrypt(d, 2), [4.0, 0.0], atol=1e-3)
    with pytest.raises(ValueError):
        ctx.dot([a], [1.0, 2.0])


@pytest.mark.slow
def test_ckks_context_dot_matches_jax_live():
    """The JAX package's ``dot`` on the port context's ciphertexts, carried
    across."""
    ctx = ckks_context()
    a, b = ctx.encrypt([1.0, 2.0]), ctx.encrypt([0.5, -1.0])
    jctx = JaxCkksContext.__new__(JaxCkksContext)
    jctx.engine = jckks.CkksEngine(jparams.ParameterSet(
        scheme=jparams.FHEScheme.CKKS, **kwargs(0)), scale=SCALE)

    def to_jax(ct):
        c0, c1, _, level, scale = ckks_ciphertext_to_numpy(ct)
        return jckks.CkksCiphertext(
            c0=tuple(tuple(jax.numpy.asarray(x) for x in r) for r in c0),
            c1=tuple(tuple(jax.numpy.asarray(x) for x in r) for r in c1),
            level=level, scale=scale, key_id=ct.key_id)

    want = jctx.dot([to_jax(a), to_jax(b)], [2.0, 4.0])
    assert digest(ctx.dot([a, b], [2.0, 4.0])) == digest(want) == \
        DIGESTS["dot"]


# ---------------------------------------------------------------------------
# tally, audit, fraud
# ---------------------------------------------------------------------------


def test_tally_stream_matches_jax(s):
    fhe, jfhe = s["fhe"], s["jfhe"]
    events = {}
    out = {}
    for side, mod, eng, cts in (("port", tally, fhe.engine, s["cts"]),
                                ("jax", jtally, jfhe.engine, s["jcts"])):
        mgr = mod.TallyStreamManager(eng)
        seen, sent = [], []
        mgr.subscribe(lambda ev, seen=seen: seen.append(
            (ev.type.value, ev.election_id, ev.data)))
        adapter = mod.TallyMessageAdapter(mgr, sent.append)
        mgr.start_election("e1")
        adapter.handle_message(json.dumps({"action": "subscribe",
                                           "electionId": "e1"}))
        for ct in cts:
            mgr.process_ballot("e1", ct)
        adapter.handle_message(json.dumps({"action": "get_tally",
                                           "electionId": "e1"}))
        adapter.handle_message("not json")
        with pytest.raises(ValueError):
            mgr.process_ballot("e2", cts[0])
        out[side] = mgr.end_election("e1")
        events[side] = (seen, [json.loads(m)["type"] for m in sent],
                        mgr.get_count("e1"))
        adapter.close()
    assert events["port"] == events["jax"]
    assert_ct(out["port"], out["jax"])
    assert fhe.decrypt_value(out["port"], s["sk"]) == (7 + 6 + 63) % T


def test_audit_trail_matches_jax():
    logs = {}
    for side, mod in (("port", audit), ("jax", jaudit)):
        ticks = iter(range(100))
        m = mod.AuditTrailManager(clock=lambda: float(next(ticks)))
        m.log(mod.AuditOperation.SYSTEM_INITIALIZED, mod.AuditActor.SYSTEM,
              "sys")
        m.log_ballot_submitted("voter-1", {"election": "e1"})
        m.log_fraud_alert({"kind": "duplicate"})
        assert m.verify_integrity() == (True, [])
        logs[side] = (m.export_json(), m.export_csv())
        back = mod.AuditTrailManager.import_json(m.export_json())
        back._entries[1].details["injected"] = True
        assert back.verify_integrity() == (False, [1])
    assert logs["port"] == logs["jax"]
    assert [e.value for e in audit.AuditOperation] == \
        [e.value for e in jaudit.AuditOperation]


def test_fraud_detector_matches_jax():
    """The pairwise duplicate scan over single-modulus ciphertexts (random
    residues; fraud.py's engine is EncryptionEngine), then the statistical,
    timing and threshold checks."""
    kw = dict(poly_degree=256, moduli=[7681], lwe_dimension=64,
              lwe_noise_std=3.2e-11, decomp_base_log=7, decomp_level=2,
              plaintext_modulus=16)
    eng = EncryptionEngine(params.ParameterSet(**kw), device="cpu")
    jeng = JaxEncryptionEngine(jparams.ParameterSet(**kw))
    rng = np.random.default_rng(8)
    polys = [[rng.integers(0, 7681, 256, dtype=np.uint64) for _ in range(2)]
             for _ in range(3)]
    cts = [Ciphertext(c0=u64_from_np(x), c1=u64_from_np(y))
           for x, y in polys]
    jcts = [JaxCiphertext(c0=jax_from_np(x), c1=jax_from_np(y))
            for x, y in polys]
    pick = [0, 1, 0, 2, 1]
    got = fraud.FraudDetector(eng).detect_duplicates([cts[i] for i in pick])
    want = jfraud.FraudDetector(jeng).detect_duplicates(
        [jcts[i] for i in pick])
    assert [(x.type.value, x.description, x.confidence, x.ballot_index)
            for x in got.alerts] == \
        [(x.type.value, x.description, x.confidence, x.ballot_index)
         for x in want.alerts]
    assert len(got.alerts) == 2 and got.ballots_analyzed == 5
    det, jdet = fraud.FraudDetector(eng), jfraud.FraudDetector(jeng)
    for d in (det, jdet):
        d.set_statistical_model(type(d.model)(10.0, 2.0))
    rates = [10, 11, 9, 300, 10]
    assert [x.description for x in det.detect_statistical_anomalies(
        rates).alerts] == [x.description for x in
                           jdet.detect_statistical_anomalies(rates).alerts]
    ballots = [fraud.TimestampedBallot(None, t, v)
               for t, v in ((0.0, "v1"), (0.01, "v1"), (5.0, "v2"))]
    jballots = [jfraud.TimestampedBallot(None, t, v)
                for t, v in ((0.0, "v1"), (0.01, "v1"), (5.0, "v2"))]
    assert [x.description for x in det.detect_timing_anomalies(
        ballots).alerts] == [x.description for x in
                             jdet.detect_timing_anomalies(jballots).alerts]
    assert det.check_threshold(101, 100).alerts
    assert not det.check_threshold(99, 100).alerts
    with pytest.raises(ValueError):
        fraud.FraudDetector(None)
