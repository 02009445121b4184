"""The port's streaming (core/streaming.py), stream pipelines
(core/streams.py) and speculative PBS (core/speculative.py) against the JAX
package on the CPU.

Streaming runs on tests/test_encrypt.py's small ring (N=256, q=7681,
t=16) with ciphertexts of random residues from numpy with a seed;
speculative PBS on tests/test_pallas_cmux.py's bootstrap shape (n_lwe=8,
N=256, k=1, zero noise) with a key the port makes from a seeded
torch.Generator, carried to JAX (convert.py), whose engine runs "mxu".
Tolerance: exact equality of every residue, torus value and decoded
message."""
import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node_fhe_accelerate_tpu.core import params as jparams
from node_fhe_accelerate_tpu.core import speculative as jspec
from node_fhe_accelerate_tpu.core import streaming as jstreaming
from node_fhe_accelerate_tpu.core import streams as jstreams
from node_fhe_accelerate_tpu.core.bootstrap import (
    BootstrapKey as JaxKey, LweCiphertext as JaxLwe, TfheEngine as JaxTfhe,
    TfheParams as JaxTfheParams)
from node_fhe_accelerate_tpu.core.encrypt import (
    Ciphertext as JaxCiphertext, EncryptionEngine as JaxEngine)
from node_fhe_accelerate_tpu.ops.u64 import (u64_from_np as jax_from_np,
                                             u64_to_np as jax_to_np)
from node_fhe_accelerate_tpu_torch.convert import bsk_to_numpy, lwe_to_numpy
from node_fhe_accelerate_tpu_torch.core import (params, speculative,
                                                streaming, streams)
from node_fhe_accelerate_tpu_torch.core.bootstrap import (LweCiphertext,
                                                          TfheEngine,
                                                          TfheParams)
from node_fhe_accelerate_tpu_torch.core.encrypt import (Ciphertext,
                                                        EncryptionEngine)
from node_fhe_accelerate_tpu_torch.ops.u64 import u64_from_np, u64_to_np

torch.set_num_threads(2)

N, Q, T = 256, 7681, 16


def small_kwargs():
    return dict(poly_degree=N, moduli=[Q], lwe_dimension=64,
                lwe_noise_std=3.2e-11, glwe_dimension=1, decomp_base_log=7,
                decomp_level=2, plaintext_modulus=T)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(jparams.ParameterSet(scheme=jparams.FHEScheme.TFHE,
                                          **small_kwargs()), noise_std=0.0)
    eng = EncryptionEngine(params.ParameterSet(scheme=params.FHEScheme.TFHE,
                                               **small_kwargs()),
                           noise_std=0.0, device="cpu")
    return eng, jeng


def random_cts(count, seed, nb=10.0):
    """(port, JAX) ciphertext pairs of random residues mod q."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        c0, c1 = (rng.integers(0, Q, N, dtype=np.uint64) for _ in range(2))
        out.append((Ciphertext(c0=u64_from_np(c0), c1=u64_from_np(c1),
                               noise_budget=nb + i),
                    JaxCiphertext(c0=jax_from_np(c0), c1=jax_from_np(c1),
                                  noise_budget=nb + i)))
    return out


def assert_ct(got, want):
    for g, w in zip((got.c0, got.c1, got.c2), (want.c0, want.c1, want.c2)):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(u64_to_np(g), jax_to_np(w))
    assert got.noise_budget == want.noise_budget
    assert got.key_id == want.key_id


# ---------------------------------------------------------------------------
# chunked processing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [64, 100, 256])
def test_split_merge_and_chunked_add_match_jax(engines, chunk):
    eng, jeng = engines
    (a, ja), (b, jb) = random_cts(2, chunk)
    proc = streaming.ChunkedCiphertextProcessor(eng, chunk)
    jproc = jstreaming.ChunkedCiphertextProcessor(jeng, chunk)
    parts, jparts = proc.split(a), jproc.split(ja)
    assert [dataclasses.astuple(p.meta) for p in parts] == \
        [dataclasses.astuple(p.meta) for p in jparts]
    assert_ct(proc.merge(parts[::-1]), jproc.merge(jparts[::-1]))
    assert_ct(proc.chunked_add(a, b), jproc.chunked_add(ja, jb))
    added = proc.chunked_add(a, b)
    np.testing.assert_array_equal(u64_to_np(added.c0),
                                  u64_to_np(eng.add(a, b).c0))
    if len(parts) > 1:
        with pytest.raises(ValueError, match="missing"):
            proc.merge(parts[:-1])
    with pytest.raises(ValueError):
        streaming.ChunkedCiphertextProcessor(eng, 0)


@pytest.mark.parametrize("chunk", [32, 100])
def test_chunked_multiply_raw_matches_jax(engines, chunk):
    """The tensor product with the NTT-domain pointwise stage chunked:
    equal to the JAX package's and to the port's unchunked
    multiply_raw."""
    eng, jeng = engines
    (a, ja), (b, jb) = random_cts(2, 7 + chunk)
    got = streaming.ChunkedCiphertextProcessor(eng, chunk) \
        .chunked_multiply_raw(a, b)
    want = jstreaming.ChunkedCiphertextProcessor(jeng, chunk) \
        .chunked_multiply_raw(ja, jb)
    assert_ct(got, want)
    direct = eng.multiply_raw(a, b)
    for x, y in zip((got.c0, got.c1, got.c2),
                    (direct.c0, direct.c1, direct.c2)):
        np.testing.assert_array_equal(u64_to_np(x), u64_to_np(y))
    assert streaming.StreamingEquivalenceVerifier.verify_multiply(
        eng, a, b, chunk)
    with pytest.raises(ValueError, match="relinearize"):
        streaming.ChunkedCiphertextProcessor(eng, chunk) \
            .chunked_multiply_raw(got, a)


def test_streaming_accumulators_match_jax(engines):
    eng, jeng = engines
    pairs = random_cts(7, 3)
    cts, jcts = [p[0] for p in pairs], [p[1] for p in pairs]
    marks, jmarks = [], []
    acc = streaming.StreamingAccumulator(eng, batch_size=3,
                                         progress=marks.append)
    jacc = jstreaming.StreamingAccumulator(jeng, batch_size=3,
                                           progress=jmarks.append)
    for ct, jct in zip(cts, jcts):
        acc.push(ct)
        jacc.push(jct)
    assert_ct(acc.result(), jacc.result())
    assert marks == jmarks == [3, 6, 7] and acc.count == 7
    proc = streaming.CiphertextStreamProcessor(eng, batch_size=2,
                                               max_in_flight=2)
    jproc = jstreaming.CiphertextStreamProcessor(jeng, batch_size=2,
                                                 max_in_flight=2)
    for ct, jct in zip(cts, jcts):
        proc.push(ct, timeout=30)
        jproc.push(jct, timeout=30)
    assert_ct(proc.result(), jproc.result())
    assert proc.count == jproc.count == 7
    assert streaming.StreamingEquivalenceVerifier.verify_add(eng, cts, 3)
    with pytest.raises(ValueError, match="empty"):
        streaming.StreamingAccumulator(eng).result()


def test_stream_worker_errors_reach_the_producer(engines):
    eng, _ = engines
    proc = streaming.CiphertextStreamProcessor(eng, batch_size=2)
    proc.push(object())
    proc.push(object())
    with pytest.raises(RuntimeError, match="worker failed"):
        proc.result()


def test_resumable_upload_matches_jax():
    payload = bytes(range(256)) * 41 + b"tail"
    up, jup = streaming.ResumableUpload(1000), jstreaming.ResumableUpload(
        1000)
    chunks = list(up.chunks("u1", payload))
    assert chunks == list(jup.chunks("u1", payload))
    for side in (streaming, jstreaming):
        rx = side.ResumableUploadReceiver(1000)
        for c in chunks[:4]:
            assert rx.receive(c)
        bad = chunks[4][:3] + (zlib.crc32(b"x"),) + chunks[4][4:]
        assert not rx.receive(bad)
        assert rx.offset("u1") == 4000
        with pytest.raises(ValueError, match="incomplete"):
            rx.complete("u1", len(payload))
        for c in side.ResumableUpload(1000).chunks("u1", payload,
                                                   rx.offset("u1")):
            assert rx.receive(c)
        assert rx.complete("u1", len(payload)) == payload
    with pytest.raises(ValueError, match="aligned"):
        next(up.chunks("u1", payload, 10))


def test_stream_pipelines_match_jax():
    out = {}
    for side in (streams, jstreams):
        sizes, marks = [], []
        stage = side.TransformStream(
            lambda xs, sizes=sizes: (sizes.append(len(xs))
                                     or [x * 10 for x in xs]),
            batch_size=4, progress=marks.append)
        add = side.AdditionStream(sum, batch_size=3)
        sink = side.CiphertextWritable().consume(
            side.pipeline(side.CiphertextReadable(range(10)), stage, add))
        enc = list(side.pipeline(range(5), side.EncryptionStream(
            lambda xs: [x + 1 for x in xs], batch_size=2),
            side.DecryptionStream(lambda xs: [x - 1 for x in xs])))
        out[side.__name__] = (sizes, marks, sink.results, sink.count, enc)
    assert out[streams.__name__] == out[jstreams.__name__]
    assert out[streams.__name__][2][-1] == sum(x * 10 for x in range(10))


# ---------------------------------------------------------------------------
# speculative PBS
# ---------------------------------------------------------------------------

SMALL = dict(n_lwe=8, poly_degree=256, glwe_dim=1, pbs_base_log=7,
             pbs_level=3, ks_base_log=4, ks_level=8, lwe_noise_std=0.0,
             glwe_noise_std=0.0, plaintext_modulus=4)


@pytest.fixture(scope="module")
def pbs():
    p = TfheParams(**SMALL)
    eng = TfheEngine(p, ext_backend="pallas", device="cpu")
    gen = torch.Generator().manual_seed(21)
    lwe_sk = eng.lwe_keygen(gen)
    bsk = eng.generate_bootstrap_key(gen, lwe_sk, eng.glwe_keygen(gen))
    g, ka, kb = bsk_to_numpy(bsk)
    jkey = JaxKey(ggsw_i8=jnp.asarray(g), ksk_a=jnp.asarray(ka),
                  ksk_b=jnp.asarray(kb), params=JaxTfheParams(**SMALL))
    msgs = torch.tensor([0, 1, 1, 0, 1])
    lwe = eng.lwe_encrypt(gen, msgs, lwe_sk)
    a, b = lwe_to_numpy(lwe)
    return dict(eng=eng, bsk=bsk, lwe_sk=lwe_sk, msgs=msgs, lwe=lwe,
                jeng=JaxTfhe(JaxTfheParams(**SMALL), ext_backend="mxu"),
                jkey=jkey, jlwe=JaxLwe(a=jnp.asarray(a), b=jnp.asarray(b)))


FUNCS = [lambda v: v, lambda v: 1 - v, lambda v: 1, lambda v: 0]


def assert_lwe(got, want):
    a, b = lwe_to_numpy(got)
    np.testing.assert_array_equal(a, np.asarray(want.a))
    np.testing.assert_array_equal(b, np.asarray(want.b))


def test_speculative_run_all_matches_jax_and_separate_bootstraps(pbs):
    """Four LUTs x five rows as one (LUT, batch) blind rotate: equal to the
    JAX package's and, LUT by LUT, to separate bootstraps."""
    eng, jeng = pbs["eng"], pbs["jeng"]
    luts = [eng.make_lut(f) for f in FUNCS]
    got = speculative.SpeculativePBS(eng).run_all(pbs["lwe"], pbs["bsk"],
                                                  luts)
    want = jspec.SpeculativePBS(jeng).run_all(
        pbs["jlwe"], pbs["jkey"], [jeng.make_lut(f) for f in FUNCS])
    assert got.a.shape == (4, 5, eng.p.n_lwe)
    assert_lwe(got, want)
    for i, lut in enumerate(luts):
        one = eng.bootstrap_with_test_poly(pbs["lwe"], pbs["bsk"], lut)
        assert torch.equal(one.a, got.a[i]) and torch.equal(one.b, got.b[i])
    dec = eng.lwe_decrypt(got, pbs["lwe_sk"])
    m = pbs["msgs"].to(torch.int32)
    assert dec.tolist() == [m.tolist(), (1 - m).tolist(), [1] * 5, [0] * 5]


@pytest.mark.parametrize("k", [2, 3])
def test_speculative_run_all_funcs_matches_jax(pbs, k):
    """Two functions (a power of two) through one many-LUT blind rotate,
    three through run_all."""
    eng, jeng = pbs["eng"], pbs["jeng"]
    got = speculative.SpeculativePBS(eng).run_all_funcs(
        pbs["lwe"], pbs["bsk"], FUNCS[:k])
    want = jspec.SpeculativePBS(jeng).run_all_funcs(
        pbs["jlwe"], pbs["jkey"], FUNCS[:k])
    assert_lwe(got, want)
    m = pbs["msgs"].to(torch.int32)
    assert eng.lwe_decrypt(got, pbs["lwe_sk"])[:2].tolist() == \
        [m.tolist(), (1 - m).tolist()]


def test_speculative_select_matches_jax(pbs):
    eng, jeng = pbs["eng"], pbs["jeng"]
    luts = [eng.make_lut(f) for f in FUNCS]
    jluts = [jeng.make_lut(f) for f in FUNCS]
    sp, jsp = speculative.SpeculativePBS(eng), jspec.SpeculativePBS(jeng)
    every = sp.run_all(pbs["lwe"], pbs["bsk"], luts)
    for sel in (0, 1, 3):
        got = sp.run_and_select(pbs["lwe"], pbs["bsk"], luts, sel)
        assert_lwe(got, jsp.run_and_select(pbs["jlwe"], pbs["jkey"], jluts,
                                           sel))
        assert torch.equal(got.a, every.a[sel])
        assert torch.equal(got.b, every.b[sel])
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 32, (3, 5, 7), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, (3, 5), dtype=np.uint64).astype(np.uint32)
    got = speculative.speculative_select(
        LweCiphertext(a=torch.from_numpy(a.view(np.int32)),
                      b=torch.from_numpy(b.view(np.int32))), 2)
    want = jspec.speculative_select(JaxLwe(a=jnp.asarray(a),
                                           b=jnp.asarray(b)), 2)
    assert_lwe(got, want)
