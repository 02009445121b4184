"""The plain reference against the program on the CPU at SMALL sizes: the
same key draws give the same keys, and a bootstrap gives the same words."""
import pytest
import torch

from benchmark.reference import tfhe_pbs as ref
from conftest import SMALL, small_cell


def _program(cfg, seed):
    from node_fhe_accelerate_tpu_torch.core.bootstrap import (TfheEngine,
                                                              TfheParams)
    fields = {f: cfg[f] for f in ("n_lwe", "poly_degree", "glwe_dim",
                                  "pbs_base_log", "pbs_level", "ks_base_log",
                                  "ks_level", "lwe_noise_std",
                                  "glwe_noise_std", "plaintext_modulus")}
    eng = TfheEngine(TfheParams(**fields), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    return eng, gen


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_keys_follow_the_draws(kind):
    cfg = small_cell(kind).config
    p = ref.Params.from_config(cfg)
    keys = ref.make_keys(torch.Generator().manual_seed(5), p)
    eng, gen = _program(cfg, 5)
    lwe_sk = eng.lwe_keygen(gen)
    glwe_sk = eng.glwe_keygen(gen)
    rows = eng.ggsw_rows(gen, lwe_sk, glwe_sk)
    assert torch.equal(lwe_sk.long(), keys.lwe_sk)
    assert torch.equal(glwe_sk.long(), keys.glwe_sk)
    assert torch.equal(ref.from_i32(rows), keys.ggsw)
    eng, gen = _program(cfg, 5)
    bsk = eng.generate_bootstrap_key(gen, eng.lwe_keygen(gen),
                                     eng.glwe_keygen(gen))
    assert torch.equal(ref.from_i32(bsk.ksk_a), keys.ksk_a)
    assert torch.equal(ref.from_i32(bsk.ksk_b), keys.ksk_b)


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("table", [(0, 1, 2, 3), (1, 0, 3, 2), (1, 0, 0, 0),
                                   (0, 1, 1, 1)])
def test_bootstrap_equals_the_program(kind, table):
    from node_fhe_accelerate_tpu_torch.core.bootstrap import LweCiphertext
    cfg = small_cell(kind).config
    p = ref.Params.from_config(cfg)
    keys = ref.make_keys(torch.Generator().manual_seed(9), p)
    eng, gen = _program(cfg, 9)
    bsk = eng.generate_bootstrap_key(gen, eng.lwe_keygen(gen),
                                     eng.glwe_keygen(gen))
    m = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1])
    a, b = ref.lwe_encrypt(torch.Generator().manual_seed(3), m, keys.lwe_sk,
                           p)
    out = eng.programmable_bootstrap(
        LweCiphertext(a=ref.to_i32(a), b=ref.to_i32(b)), bsk,
        eng.make_lut(lambda v: table[v]))
    a_ref, b_ref = ref.bootstrap(keys, p, a, b, table)
    assert torch.equal(ref.from_i32(out.a), a_ref)
    assert torch.equal(ref.from_i32(out.b), b_ref)
    want = torch.tensor([table[v] for v in m.tolist()])
    assert torch.equal(ref.decode(a_ref, b_ref, keys.lwe_sk, p), want)


def test_test_poly_equals_the_program():
    cfg = small_cell("k4").config
    eng, _ = _program(cfg, 0)
    p = ref.Params.from_config(cfg)
    for table in [(0, 1, 2, 3), (1, 0, 0, 0), (3, 2, 1, 0)]:
        got = ref.test_poly(table, p, "cpu")
        assert torch.equal(ref.from_i32(eng.make_lut(lambda v: table[v])),
                           got)


@pytest.mark.parametrize("base_log,level", [(8, 2), (7, 3), (2, 8)])
def test_decomposition_recombines(base_log, level):
    x = ref._words(torch.Generator().manual_seed(1), (4096,))
    d = ref._decompose(x, base_log, level)
    assert int(d.min()) >= -(1 << (base_log - 1))
    assert int(d.max()) < (1 << (base_log - 1))
    w = torch.tensor([1 << (32 - (l + 1) * base_log) for l in range(level)])
    back = (d * w).sum(-1) & ref.MASK
    err = ((x - back + (1 << 31)) & ref.MASK) - (1 << 31)
    assert int(err.abs().max()) <= 1 << (32 - level * base_log - 1)


def test_encrypt_decode_round_trip():
    p = ref.Params.from_config(small_cell("k4").config)
    sk = ref.lwe_secret(torch.Generator().manual_seed(2), p)
    m = torch.tensor([0, 1, 2, 3] * 4)
    a, b = ref.lwe_encrypt(torch.Generator().manual_seed(4), m, sk, p)
    assert torch.equal(ref.decode(a, b, sk, p), m)
