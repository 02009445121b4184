"""The port's adaptive dispatcher (utils/dispatch.py), the engine's default
"auto" backend (core/bootstrap.py) and the MSM's band race
(zk/curve.py ``msm_race``), against the JAX package's rules on the CPU.

The race runs on stub candidates with known costs (sleeps, a candidate
that declares itself unsupported, one that fails); "auto" is checked by how
it resolves on the CPU, where neither package races, and by its race built
as on the card over the candidates' plain versions.  Tolerance: exact equality of names, keys and values."""
import dataclasses
import gc
import time
import weakref

import jax.numpy as jnp
import pytest
import torch

from node_fhe_accelerate_tpu.core.bootstrap import (TfheEngine as JaxEngine,
                                                    TfheParams as JaxParams)
from node_fhe_accelerate_tpu.utils import dispatch as jdispatch
from node_fhe_accelerate_tpu_torch.core.bootstrap import (
    TFHE_BOOT_128, TFHE_BOOT_128_K4, TFHE_BOOT_128_K4T, TFHE_BOOT_128_L2,
    BootstrapKey, LweCiphertext, TfheEngine, TfheParams)
from node_fhe_accelerate_tpu_torch.core import bootstrap
from node_fhe_accelerate_tpu_torch.parallel.mesh import gather, make_mesh
from node_fhe_accelerate_tpu_torch.parallel.pbs import (replicate_bsk,
                                                        sharded_bootstrap_fn)
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


def test_a_winner_that_turns_unsupported_hands_the_call_to_the_runner_up():
    """A winner raising ``Unsupported`` on a later call of its shape class
    (a new key whose form no longer fits) hands that call to the race's
    next fastest candidate that takes it, with no new race: the class
    keeps its winner and its timings, and the winner takes the calls it
    can again.  A call that no candidate takes raises ``Unsupported``."""
    d = dispatch.AdaptiveDispatcher(warmup=1, iters=1)
    calls = dict(slow=0, fast=0, broken=0)
    slow, fast, broken = stubs(calls)
    fits = [True]

    def fast_while_it_fits(x):
        if not fits[0]:
            raise dispatch.Unsupported("no longer fits")
        return fast(x)

    d.register("inc", "broken", broken)
    d.register("inc", "slow", slow)
    d.register("inc", "fast", fast_while_it_fits)
    x = torch.ones(4, dtype=torch.int32)
    d.dispatch("inc", x)
    race = d.selection_table()
    fits[0] = False
    assert torch.equal(d.dispatch("inc", x), x + 1)
    assert d.winners("inc") == {"fast"} and d.selection_table() == race
    assert calls == dict(slow=2 + 1, fast=2 + 1, broken=1)
    fits[0] = True
    d.dispatch("inc", x)
    assert calls == dict(slow=3, fast=4, broken=1)
    alone = dispatch.AdaptiveDispatcher(warmup=1, iters=1)
    alone.register("inc", "broken", broken)
    alone.register("inc", "fast", fast_while_it_fits)
    alone.dispatch("inc", x)
    fits[0] = False
    with pytest.raises(dispatch.Unsupported):
        alone.dispatch("inc", x)
    assert calls["broken"] == 1 + 1 + 1


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


def free_memory(monkeypatch, free):
    """``torch.cuda.mem_get_info`` reading ``free`` bytes free."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 1 << 40))


def count_slab_builds(monkeypatch):
    """Count the builds of K-major slabs, keeping a weak reference to each
    form built."""
    built = []
    real = bootstrap.build_all_step_kslabs

    def build(g):
        out = real(g)
        built.append(weakref.ref(out))
        return out

    monkeypatch.setattr(bootstrap, "build_all_step_kslabs", build)
    return built


def slow_down(eng, names, secs=0.05):
    """Make the race's candidates ``names`` lose: each call sleeps first."""
    def slowed(fn):
        def run(*args):
            time.sleep(secs)
            return fn(*args)
        return run

    for c in eng.dispatcher._candidates["pbs"]:
        if c.name in names:
            c.fn = slowed(c.fn)


def test_auto_race_routes_the_bootstrap(monkeypatch):
    """The race as the card builds it, here over the candidates' plain
    versions on the CPU: every candidate gets a finite time, and "auto"
    routes bootstrap_with_test_poly (and so bootstrap and the comparisons)
    to the winner, bit-equal to it named explicitly."""
    p, eng, sk, bsk, msgs, ct = auto_race_setup()
    free_memory(monkeypatch, 1 << 40)
    eng._route_through_race()
    assert [c.name for c in eng.dispatcher._candidates["pbs"]] == \
        ["pallas", "mxu", "pallas_fused", "mxu_fused"]
    got = eng.bootstrap(ct, bsk)
    (key, sel), = eng.dispatcher.selection_table().items()
    assert key[0] == "pbs"
    assert sorted(sel["timings"]) == ["mxu", "mxu_fused", "pallas",
                                      "pallas_fused"]
    assert all(t < float("inf") for t in sel["timings"].values())
    want = TfheEngine(p, ext_backend=sel["winner"], device="cpu").bootstrap(
        ct, bsk)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    assert torch.equal(eng.lwe_decrypt(got, sk), msgs.to(torch.int32))


# the slabs of auto_race_setup's key take 4 steps x (2*4*128) x (3*2*128) =
# 3,145,728 bytes; they fit when they are at most half the free memory, or
# when the key carries them
@pytest.mark.parametrize("free,carried,races", [
    (2 * 3145728, False, True), (2 * 3145728 - 1, False, False),
    (0, True, True)], ids=["fits", "one_byte_short", "carried_by_the_key"])
def test_auto_race_takes_mxu_fused_by_the_memory_rule(monkeypatch, free,
                                                      carried, races):
    """"mxu_fused" runs in the race when the key's K-major slabs fit in
    KSLABS_SHARE_OF_FREE of the free memory or come with the key, and
    otherwise sits it out (time inf) without building them."""
    p, eng, sk, bsk, msgs, ct = auto_race_setup()
    if carried:
        bsk = eng.prepare_bsk(bsk, "slabs")
    built = count_slab_builds(monkeypatch)
    free_memory(monkeypatch, free)
    eng._route_through_race()
    got = eng.bootstrap(ct, bsk)
    (sel,) = eng.dispatcher.selection_table().values()
    assert (sel["timings"]["mxu_fused"] < float("inf")) == races
    assert all(t < float("inf") for n, t in sel["timings"].items()
               if n != "mxu_fused")
    assert len(built) == (1 if races and not carried else 0)
    assert torch.equal(eng.lwe_decrypt(got, sk), msgs.to(torch.int32))


@pytest.mark.parametrize("wins", [True, False],
                         ids=["mxu_fused_wins", "mxu_fused_loses"])
def test_auto_race_builds_the_slabs_once_per_key(monkeypatch, wins):
    """The race's warm-up builds a key's slabs; its timed calls, later
    calls, the positions of a sharded bootstrap on the key's device and a
    race of another batch shape reuse them; they go with the key.  When
    "mxu_fused" wins no shape they are dropped after the race."""
    p, eng, sk, bsk, msgs, ct = auto_race_setup()
    built = count_slab_builds(monkeypatch)
    free_memory(monkeypatch, 1 << 40)
    eng._route_through_race()
    winner = "mxu_fused" if wins else "pallas"
    slow_down(eng, {"pallas", "mxu", "pallas_fused", "mxu_fused"} - {winner})
    got = eng.bootstrap(ct, bsk)
    assert eng.dispatcher.winners("pbs") == {winner}
    assert len(built) == 1
    assert torch.equal(eng.lwe_decrypt(got, sk), msgs.to(torch.int32))
    if not wins:
        assert len(eng._kslabs) == 0 and built[0]() is None
        return
    assert eng._kslabs[bsk.ggsw_i8] is built[0]()
    for _ in range(2):
        eng.bootstrap(ct, bsk)
    mesh = make_mesh(2, data=2, devices=["cpu"] * 2)
    out = gather(sharded_bootstrap_fn(eng, mesh)(
        ct, replicate_bsk(bsk, mesh), eng.default_test_poly()))
    assert torch.equal(out.a, got.a) and torch.equal(out.b, got.b)
    assert len(eng.dispatcher.selection_table()) == 2
    assert len(built) == 1
    del bsk, out
    gc.collect()
    assert len(eng._kslabs) == 0 and built[0]() is None


def test_auto_race_sends_a_key_whose_slabs_do_not_fit_to_the_runner_up(
        monkeypatch):
    """After "mxu_fused" wins, a second key whose slabs no longer fit goes
    to the race's runner-up, bit-equal to it named explicitly, with no new
    race; the first key keeps its slabs and its route."""
    p, eng, sk, bsk, msgs, ct = auto_race_setup()
    built = count_slab_builds(monkeypatch)
    free_memory(monkeypatch, 1 << 40)
    eng._route_through_race()
    slow_down(eng, {"pallas", "mxu", "pallas_fused"})
    first = eng.bootstrap(ct, bsk)
    race = eng.dispatcher.selection_table()
    (sel,) = race.values()
    assert sel["winner"] == "mxu_fused"
    runner_up = sorted(sel["timings"], key=sel["timings"].get)[1]
    gen = torch.Generator().manual_seed(1)
    bsk2 = eng.generate_bootstrap_key(gen, sk, eng.glwe_keygen(gen))
    free_memory(monkeypatch, 0)
    got = eng.bootstrap(ct, bsk2)
    want = TfheEngine(p, ext_backend=runner_up, device="cpu").bootstrap(
        ct, bsk2)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    assert torch.equal(eng.lwe_decrypt(got, sk), msgs.to(torch.int32))
    assert eng.dispatcher.selection_table() == race
    assert bsk2.ggsw_i8 not in eng._kslabs
    again = eng.bootstrap(ct, bsk)
    assert torch.equal(again.a, first.a) and torch.equal(again.b, first.b)
    assert len(built) == 1 and eng._kslabs[bsk.ggsw_i8] is built[0]()


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
