"""The ablation copies of scripts/ablate_cmux_kernels.py,
scripts/ablate_ntt_kernels.py and scripts/ablate_point_ops.py are made by
replacing texts of csrc/cmux_common.cuh, csrc/cmux_step.cu,
csrc/ladder_steps.cu, csrc/ntt.cu and csrc/digits.cu.  Their timing needs the card; the edits are checked here, so
that a change of the kernels that moves a replaced text fails on the CPU
instead of on the card."""
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "ablate_cmux_kernels", os.path.join(ROOT, "scripts",
                                        "ablate_cmux_kernels.py"))
ablate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ablate)
_spec = importlib.util.spec_from_file_location(
    "ablate_ntt_kernels", os.path.join(ROOT, "scripts",
                                       "ablate_ntt_kernels.py"))
ablate_ntt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ablate_ntt)
_spec = importlib.util.spec_from_file_location(
    "ablate_point_ops", os.path.join(ROOT, "scripts", "ablate_point_ops.py"))
ablate_point = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ablate_point)


@pytest.mark.parametrize("name", list(ablate.ABLATIONS))
def test_ablation_edits_apply(name):
    source, edits = ablate.ABLATIONS[name]
    header, text = ablate.ablated_sources(name)
    with open(os.path.join(ablate.CSRC, "cmux_common.cuh")) as f:
        orig_header = f.read()
    with open(os.path.join(ablate.CSRC, source)) as f:
        orig_text = f.read()
    assert (header, text) != (orig_header, orig_text) or not edits
    for new in edits.values():
        assert new in header or new in text


def test_ablation_refuses_a_missing_text(monkeypatch):
    monkeypatch.setitem(ablate.ABLATIONS, "broken",
                        ("cmux_step.cu", {"no such text": ";"}))
    with pytest.raises(RuntimeError, match="exactly once"):
        ablate.ablated_sources("broken")


@pytest.mark.parametrize("name", list(ablate_ntt.ABLATIONS))
def test_ntt_ablation_edits_apply(name):
    edits = ablate_ntt.ABLATIONS[name]
    text = ablate_ntt.ablated_source(name)
    with open(os.path.join(ablate_ntt.CSRC, "ntt.cu")) as f:
        assert (text != f.read()) == bool(edits)
    for old, new in edits.items():
        assert new in text and (old not in text or old in new)


def test_ntt_ablation_refuses_a_missing_text(monkeypatch):
    monkeypatch.setitem(ablate_ntt.ABLATIONS, "broken",
                        {"no such text": ";"})
    with pytest.raises(RuntimeError, match="exactly once"):
        ablate_ntt.ablated_source("broken")


@pytest.mark.parametrize("name", list(ablate_point.ABLATIONS))
def test_point_ablation_edits_apply(name):
    edits = ablate_point.ABLATIONS[name]
    text = ablate_point.ablated_source(name)
    with open(os.path.join(ablate_ntt.CSRC, "digits.cu")) as f:
        assert (text != f.read()) == bool(edits)
    for old, new in edits.items():
        assert new in text and old not in text
