"""Speculative execution: multi-LUT PBS and oblivious selection
(counterpart of node_fhe_accelerate_tpu/core/speculative.py).

The reference's ``SpeculativePBS`` (cpp/include/speculative_executor.h)
evaluates a PBS for every possible LUT in a thread pool and selects
obliviously.  Here the LUT axis is a batch axis of one bootstrap: the
accumulators differ per LUT and the CMux ladder is shared, so on the card
the ladder is the engine's kernel (K1 per step through ``"pallas"``, the
backend an ``"auto"`` engine's ``blind_rotate`` takes) over (LUTs x batch)
rows at once.  The selection is a one-hot weighted sum, with no
data-dependent control flow.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .bootstrap import BootstrapKey, LweCiphertext, TfheEngine

__all__ = ["SpeculativePBS", "speculative_select"]


class SpeculativePBS:
    """Evaluate one input under many LUTs in a single batched bootstrap."""

    def __init__(self, engine: TfheEngine):
        self.engine = engine

    def run_all(self, lwe: LweCiphertext, bsk: BootstrapKey,
                luts: Sequence) -> LweCiphertext:
        """Bootstrap the same ciphertext under every LUT at once: an LWE
        batch with a leading axis len(luts)."""
        eng = self.engine
        p = eng.p
        k = len(luts)
        lut_stack = torch.stack(list(luts))                 # (k, N)
        batched = LweCiphertext(a=lwe.a.expand((k,) + lwe.a.shape),
                                b=lwe.b.expand((k,) + lwe.b.shape))
        acc = torch.zeros((k,) + lwe.b.shape + (p.glwe_dim + 1,
                                                 p.poly_degree),
                          dtype=torch.int32, device=lwe.b.device)
        tp = lut_stack.reshape((k,) + (1,) * lwe.b.dim() + (p.poly_degree,))
        acc[..., p.glwe_dim, :] = tp
        acc = eng.blind_rotate(acc, batched, bsk)
        return eng.key_switch(eng.sample_extract(acc), bsk)

    def run_all_funcs(self, lwe: LweCiphertext, bsk: BootstrapKey,
                      funcs: Sequence) -> LweCiphertext:
        """As run_all but from plaintext functions: one blind rotate for
        all of them through many-LUT bootstrapping when their count is a
        power of two within the window budget (K times cheaper), else
        run_all."""
        K = len(funcs)
        eng = self.engine
        if K and not (K & (K - 1)) and eng.t * K <= eng.p.poly_degree:
            return eng.bootstrap_many_lut(lwe, bsk, funcs)
        return self.run_all(lwe, bsk, [eng.make_lut(f) for f in funcs])

    def run_and_select(self, lwe: LweCiphertext, bsk: BootstrapKey,
                       luts: Sequence, selector: int) -> LweCiphertext:
        """All-LUT evaluation and oblivious selection
        (speculative_executor.cpp:151-192)."""
        return speculative_select(self.run_all(lwe, bsk, luts), selector)


def speculative_select(batched: LweCiphertext, index) -> LweCiphertext:
    """One result of a LUT-batched LWE, selected obliviously: a one-hot
    weighted sum mod 2^32."""
    k = batched.a.shape[0]
    onehot = (torch.arange(k, device=batched.a.device)
              == torch.as_tensor(index, device=batched.a.device)).to(
                  torch.int64)
    a = (batched.a.to(torch.int64)
         * onehot.reshape((k,) + (1,) * (batched.a.dim() - 1))).sum(0)
    b = (batched.b.to(torch.int64)
         * onehot.reshape((k,) + (1,) * (batched.b.dim() - 1))).sum(0)
    return LweCiphertext(a=a.to(torch.int32), b=b.to(torch.int32))
