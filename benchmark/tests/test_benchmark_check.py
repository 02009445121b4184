"""The check that decides ``correct``: sound runs pass it; the control (the
program's truncated bootstrap key) and each fault the cells can have,
planted under the timed path, fail it.  The harness's look for a card is
skipped: the runs drive the rest of a run on the CPU at SMALL sizes."""
import pytest
import torch

from conftest import SMALL, run_small, small_cell


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(kind, trace):
    res, out = run_small(small_cell(kind), trace=trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["attempted"] == 8 * (4 + (2 if trace else 0))
    assert list(res)[-1] == "checks"
    if trace:
        assert {"host_enqueue_ms", "race_s", "keygen_s"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"pbs_per_s", "pbs_call_p95_ms",
                                       "setup_s"}


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_control_truncated_key_is_not_correct(kind):
    res, _ = run_small(small_cell(kind), bsk_drop_planes=1)
    assert not res["correct"]
    assert res["checks"]["words_differ"]["value"] > 0


def test_fault_step_returns_its_state(monkeypatch):
    from node_fhe_accelerate_tpu_torch.core.bootstrap import TfheEngine
    monkeypatch.setattr(TfheEngine, "cmux",
                        lambda self, row, ct0, ct1: ct0)
    res, _ = run_small(small_cell("k4"))
    assert not res["correct"]
    assert res["checks"]["words_differ"]["value"] > 0


def test_fault_half_the_batch_left_out(monkeypatch):
    from node_fhe_accelerate_tpu_torch.api.engine import FHEEngine
    from node_fhe_accelerate_tpu_torch.core.bootstrap import LweCiphertext
    whole = FHEEngine.programmable_bootstrap

    def half(self, lwe, bsk, fn):
        h = lwe.b.shape[0] // 2
        out = whole(self, LweCiphertext(a=lwe.a[:h], b=lwe.b[:h]), bsk, fn)
        return LweCiphertext(a=torch.cat([out.a, out.a]),
                             b=torch.cat([out.b, out.b]))

    monkeypatch.setattr(FHEEngine, "programmable_bootstrap", half)
    res, _ = run_small(small_cell("k4"))
    assert not res["correct"]


def test_fault_answer_altered_where_produced(monkeypatch):
    from node_fhe_accelerate_tpu_torch.core.bootstrap import TfheEngine
    switch = TfheEngine.key_switch

    def altered(self, lwe, bsk):
        out = switch(self, lwe, bsk)
        out.b[0] ^= 1
        return out

    monkeypatch.setattr(TfheEngine, "key_switch", altered)
    res, _ = run_small(small_cell("k4"))
    assert not res["correct"]
    # one low bit: every row still decodes; only the word comparison sees it
    assert res["checks"]["rows_wrong"]["value"] == 0
    assert res["checks"]["words_differ"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(SMALL))
def test_small_cell_on_the_card(card, kind):
    res, _ = run_small(small_cell(kind, rows=256), trace=True, device=card)
    assert res["correct"], res["checks"]
    res, _ = run_small(small_cell(kind, rows=256), device=card,
                       bsk_drop_planes=1)
    assert not res["correct"]
