"""The port's adaptive dispatcher (utils/dispatch.py), the engine's default
"auto" backend (core/bootstrap.py) and the MSM's band race
(zk/curve.py ``msm_race``), against the JAX package's rules on the CPU.

The race runs on stub candidates with known costs (sleeps, a candidate
that declares itself unsupported, one that fails); "auto" is checked by how
it resolves on the CPU, where neither package races, and by its race built
as on the card over the candidates' plain versions.  Tolerance: exact equality of names, keys and values."""
import dataclasses
import time

import jax.numpy as jnp
import pytest
import torch

from node_fhe_accelerate_tpu.core.bootstrap import (TfheEngine as JaxEngine,
                                                    TfheParams as JaxParams)
from node_fhe_accelerate_tpu.utils import dispatch as jdispatch
from node_fhe_accelerate_tpu_torch.core.bootstrap import (
    TFHE_BOOT_128, TFHE_BOOT_128_K4, TFHE_BOOT_128_K4T, TFHE_BOOT_128_L2,
    BootstrapKey, LweCiphertext, TfheEngine, TfheParams)
from node_fhe_accelerate_tpu_torch.utils import dispatch
from node_fhe_accelerate_tpu_torch.zk.curve import bn254_g1

torch.set_num_threads(2)


def stubs(calls):
    def slow(x):
        calls["slow"] += 1
        time.sleep(0.01)
        return x + 1

    def fast(x):
        calls["fast"] += 1
        return x + 1

    def broken(x):
        calls["broken"] += 1
        raise dispatch.Unsupported("not this shape")

    return slow, fast, broken


def failing(*args):
    raise RuntimeError("kernel failed to launch")


def test_race_picks_the_faster_candidate_and_caches_it():
    d = dispatch.AdaptiveDispatcher(warmup=1, iters=2)
    calls = dict(slow=0, fast=0, broken=0)
    slow, fast, broken = stubs(calls)
    for name, fn in (("slow", slow), ("broken", broken), ("fast", fast)):
        d.register("inc", name, fn)
    x = torch.ones(4, dtype=torch.int32)
    out = d.dispatch("inc", x)
    assert torch.equal(out, x + 1)
    (key, sel), = d.selection_table().items()
    assert key == ("inc", ((4, "torch.int32"),))
    assert sel["winner"] == "fast"
    assert sel["timings"]["broken"] == float("inf")
    assert sel["timings"]["slow"] >= 0.01 > sel["timings"]["fast"]
    # each candidate ran warmup + iters times, the winner once more
    assert calls == dict(slow=3, fast=4, broken=1)
    before = dict(calls)
    d.dispatch("inc", x + 5)
    assert calls == dict(before, fast=before["fast"] + 1)
    assert d.selection_for("inc", x) == "fast"
    # another shape class races again
    d.dispatch("inc", torch.ones(8, dtype=torch.int32))
    assert len(d.selection_table()) == 2
    assert calls["slow"] == 6


def test_race_fails_when_every_candidate_raises():
    d = dispatch.AdaptiveDispatcher()
    calls = dict(slow=0, fast=0, broken=0)
    d.register("op", "broken", stubs(calls)[2])
    with pytest.raises(RuntimeError):
        d.dispatch("op", torch.zeros(2))
    with pytest.raises(KeyError):
        dispatch.AdaptiveDispatcher().dispatch("nope", 1)
    with pytest.raises(KeyError):
        dispatch.AdaptiveDispatcher().selection_for("nope", 1)


def test_race_propagates_a_failing_candidate():
    """Only ``Unsupported`` loses the race: any other error (a kernel that
    does not build or launch) stops it, and nothing is cached."""
    d = dispatch.AdaptiveDispatcher()
    calls = dict(slow=0, fast=0, broken=0)
    d.register("op", "fast", stubs(calls)[1])
    d.register("op", "failing", failing)
    assert d.has("op") and not d.has("nope")
    assert [c.name for c in d._candidates["op"]] == ["fast", "failing"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        d.dispatch("op", torch.zeros(2, dtype=torch.int32))
    assert d.selection_table() == {}


def test_shape_class_and_perturb_walk_the_port_dataclasses():
    """Leaves in the JAX pytree order: the LWE's (a, b), the key's GGSW
    forms in its field order, nested limb-plane tuples, scalars by type."""
    lwe = LweCiphertext(a=torch.zeros(3, 5, dtype=torch.int32),
                        b=torch.zeros(3, dtype=torch.int32))
    bsk = BootstrapKey(ksk_a=torch.zeros(2, 1, 5, dtype=torch.int32),
                       ksk_b=torch.zeros(2, 1, dtype=torch.int32),
                       params=TFHE_BOOT_128(),
                       ggsw_ext=(torch.zeros(4, dtype=torch.int32),
                                 torch.zeros(4, dtype=torch.int32)))
    d = dispatch.AdaptiveDispatcher()
    sc = d._shape_class((lwe, bsk, 7))
    assert sc[:2] == ((3, 5, "torch.int32"), (3, "torch.int32"))
    assert sc[-1] == "int"
    assert (4, "torch.int32") in sc and (2, 1, 5, "torch.int32") in sc
    got = dispatch._perturb((lwe, bsk, 7), 3)
    assert isinstance(got[0], LweCiphertext)
    assert torch.equal(got[0].a, lwe.a ^ 3) and got[0].b is lwe.b
    assert got[1] is bsk and got[2] == 7
    assert dispatch._perturb((lwe,), 0)[0] is lwe
    floats = (torch.zeros(2), (torch.zeros(2, dtype=torch.int64),))
    got = dispatch._perturb(floats, 2)
    assert got[0] is floats[0] and torch.equal(got[1][0],
                                               torch.full((2,), 2))
    # the JAX dispatcher's shape class of the same arrays
    jd = jdispatch.AdaptiveDispatcher()
    jsc = jd._shape_class((jnp.zeros((3, 5), jnp.int32), 7))
    assert d._shape_class((torch.zeros(3, 5, dtype=torch.int32), 7)) == \
        tuple((s[:-1] + ("torch." + s[-1],)) if isinstance(s, tuple) else s
              for s in jsc)


def test_global_dispatcher_is_shared():
    assert dispatch.global_dispatcher() is dispatch.global_dispatcher()


def jax_backend(p, **kw):
    return JaxEngine(JaxParams(**dataclasses.asdict(p)), **kw).backend


TFHE_256 = TfheParams(n_lwe=1024, poly_degree=4096, glwe_dim=1,
                      pbs_base_log=10, pbs_level=3, ks_base_log=4,
                      ks_level=8, plaintext_modulus=16)


@pytest.mark.parametrize("p,want", [
    (TFHE_BOOT_128(), "mxu"), (TFHE_BOOT_128_L2(), "mxu"),
    (TFHE_BOOT_128_K4(), "mxu"), (TFHE_BOOT_128_K4T(), "mxu"),
    (TFHE_256, "mxu"),
    (dataclasses.replace(TFHE_256, pbs_base_log=11), "crt"),
    (TfheParams(n_lwe=8, poly_degree=64, pbs_base_log=7, pbs_level=3),
     "crt")], ids=["k1", "l2", "k4", "k4t", "tfhe256", "tfhe256_bg2048",
        "n64"])
def test_auto_resolves_as_the_jax_package_on_the_cpu(p, want):
    """CPU -> "mxu" when the int8 accumulation bound holds (no race; it
    holds at TFHE_256's l(k+1)N = 24576 with Bg = 2^10), "crt" when it
    fails (Bg = 2^11 there, or N % 128), a truncated key -> "mxu"; the
    default constructor is "auto"."""
    for kw in ({}, {"ext_backend": "auto"}):
        eng = TfheEngine(p, device="cpu", **kw)
        assert eng.backend == want == jax_backend(p, **kw)
        assert eng.dispatcher is None
    # a truncated key pins "auto" to "mxu" and refuses the others
    if p.bsk_drop_planes:
        with pytest.raises(ValueError):
            TfheEngine(p, ext_backend="crt", device="cpu")


def auto_race_setup():
    p = TfheParams(n_lwe=4, poly_degree=128, glwe_dim=1, pbs_base_log=7,
                   pbs_level=3, ks_base_log=4, ks_level=8,
                   lwe_noise_std=0.0, glwe_noise_std=0.0)
    eng = TfheEngine(p, ext_backend="pallas", device="cpu")
    gen = torch.Generator().manual_seed(0)
    sk = eng.lwe_keygen(gen)
    bsk = eng.generate_bootstrap_key(gen, sk, eng.glwe_keygen(gen))
    msgs = torch.arange(6) % 2
    return p, eng, sk, bsk, msgs, eng.lwe_encrypt(gen, msgs, sk)


def test_auto_race_routes_the_bootstrap(monkeypatch):
    """The race as the card builds it, here over the candidates' plain
    versions on the CPU: every candidate gets a finite time, and "auto"
    routes bootstrap_with_test_poly (and so bootstrap and the comparisons)
    to the winner, bit-equal to it named explicitly."""
    p, eng, sk, bsk, msgs, ct = auto_race_setup()
    monkeypatch.setenv("NFA_ADAPTIVE_FUSED", "1")
    eng._route_through_race()
    assert [c.name for c in eng.dispatcher._candidates["pbs"]] == \
        ["pallas", "mxu", "pallas_fused"]
    got = eng.bootstrap(ct, bsk)
    (key, sel), = eng.dispatcher.selection_table().items()
    assert key[0] == "pbs"
    assert sorted(sel["timings"]) == ["mxu", "pallas", "pallas_fused"]
    assert all(t < float("inf") for t in sel["timings"].values())
    want = TfheEngine(p, ext_backend=sel["winner"], device="cpu").bootstrap(
        ct, bsk)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    assert torch.equal(eng.lwe_decrypt(got, sk), msgs.to(torch.int32))


def test_auto_race_raises_when_a_kernel_candidate_fails():
    """A kernel candidate that fails does not lose the race to the plain
    "mxu": its error reaches the caller."""
    p, eng, sk, bsk, msgs, ct = auto_race_setup()
    eng._route_through_race()
    for c in eng.dispatcher._candidates["pbs"]:
        if c.name != "mxu":
            c.fn = failing
    with pytest.raises(RuntimeError, match="failed to launch"):
        eng.bootstrap(ct, bsk)
    assert eng.dispatcher.selection_table() == {}


def test_msm_race_registers_both_candidates_once():
    c = bn254_g1(device="cpu")
    disp, op = c.msm_race()
    assert disp is dispatch.global_dispatcher()
    assert op == f"msm_{c.fq.q % 100003}_{id(c)}"
    assert [x.name for x in disp._candidates[op]] == ["pippenger", "ladder"]
    assert c.msm_race() == (disp, op)
    assert len(disp._candidates[op]) == 2


def test_engine_without_card_raises_before_resolving():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        TfheEngine(TFHE_BOOT_128_K4())
    with pytest.raises(RuntimeError):
        TfheEngine(TFHE_BOOT_128_K4(), ext_backend="bogus")
