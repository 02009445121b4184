"""Chunked / streaming ciphertext processing (counterpart of
node_fhe_accelerate_tpu/core/streaming.py).

Twin of the reference's `ChunkedCiphertextProcessor` /
`CiphertextStreamProcessor` / `StreamingEquivalenceVerifier`
(cpp/include/streaming_processor.h:155-422, src/streaming/index.ts:16-633):

* split/merge of ciphertexts into coefficient-range chunks with exact
  reassembly;
* chunk-wise homomorphic addition (bit-identical to unchunked — chunk
  boundaries are trivial for coefficient-wise ops);
* a streaming accumulator that folds unbounded ballot streams in
  bounded-memory batches (tree reduction per batch, running modular sum
  across batches) with progress callbacks and backpressure-style max
  in-flight control;
* an equivalence verifier asserting streamed == direct results
  (Property 10, streaming-equivalence.prop.test.ts).
"""
from __future__ import annotations

import math
import queue
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .encrypt import Ciphertext, EncryptionEngine, _row, _stack
from .poly import PolyRing

__all__ = ["ChunkMetadata", "ChunkedCiphertextProcessor",
           "StreamingAccumulator", "CiphertextStreamProcessor",
           "StreamingEquivalenceVerifier"]


@dataclass
class ChunkMetadata:
    """(streaming_processor.h ChunkMetadata)"""
    chunk_index: int
    total_chunks: int
    start_coeff: int
    end_coeff: int            # exclusive
    degree: int


@dataclass
class CiphertextChunk:
    meta: ChunkMetadata
    c0: tuple                 # limb planes (chunk_len,)
    c1: tuple


class ChunkedCiphertextProcessor:
    """Split/merge/process ciphertexts chunk-wise
    (streaming_processor.h:155-270)."""

    def __init__(self, engine: EncryptionEngine, chunk_size: int):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.engine = engine
        self.ring: PolyRing = engine.ring
        self.chunk_size = chunk_size

    def split(self, ct: Ciphertext) -> list:
        n = self.ring.n
        cs = self.chunk_size
        total = -(-n // cs)
        out = []
        for i in range(total):
            lo, hi = i * cs, min((i + 1) * cs, n)
            meta = ChunkMetadata(chunk_index=i, total_chunks=total,
                                 start_coeff=lo, end_coeff=hi, degree=n)
            out.append(CiphertextChunk(
                meta=meta,
                c0=(ct.c0[0][..., lo:hi], ct.c0[1][..., lo:hi]),
                c1=(ct.c1[0][..., lo:hi], ct.c1[1][..., lo:hi])))
        return out

    def merge(self, chunks: list) -> Ciphertext:
        chunks = sorted(chunks, key=lambda c: c.meta.chunk_index)
        if chunks[0].meta.total_chunks != len(chunks):
            raise ValueError("missing chunks")
        c0 = (torch.cat([c.c0[0] for c in chunks], dim=-1),
              torch.cat([c.c0[1] for c in chunks], dim=-1))
        c1 = (torch.cat([c.c1[0] for c in chunks], dim=-1),
              torch.cat([c.c1[1] for c in chunks], dim=-1))
        return Ciphertext(c0=c0, c1=c1,
                          noise_budget=self.engine.initial_noise_budget)

    def chunked_add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Add chunk-by-chunk; bit-identical to engine.add (Property 10)."""
        ring = self.ring
        out = []
        for ca, cb in zip(self.split(a), self.split(b)):
            out.append(CiphertextChunk(
                meta=ca.meta,
                c0=ring.ctx.add(ca.c0, cb.c0),
                c1=ring.ctx.add(ca.c1, cb.c1)))
        return self.merge(out)

    def chunked_multiply_raw(self, a: Ciphertext, b: Ciphertext
                             ) -> Ciphertext:
        """Tensor product with the POINTWISE stage chunked (bounded live
        working set per product), bit-identical to engine.multiply_raw.

        The reference chunks coefficient ranges and then corrects chunk
        boundaries because convolution crosses them
        (streaming_processor.h:302-422).  This design chunks in the NTT
        domain instead, where the product is elementwise and chunk
        boundaries need no correction at all.  The transforms are one
        forward launch of the four operands and one inverse launch of the
        three products (K6/K7 on the card), as in multiply_raw.
        """
        ring = self.ring
        if a.is_degree_2 or b.is_degree_2:
            raise ValueError("relinearize before multiplying degree-2")
        cs = self.chunk_size
        n = ring.n
        f = ring.to_ntt(_stack([a.c0, a.c1, b.c0, b.c1]))
        fa0, fa1, fb0, fb1 = (_row(f, i) for i in range(4))

        def piecewise(fx, fy):
            parts = []
            for lo in range(0, n, cs):
                sl = slice(lo, min(lo + cs, n))
                parts.append(ring.pointwise(
                    (fx[0][..., sl], fx[1][..., sl]),
                    (fy[0][..., sl], fy[1][..., sl])))
            return (torch.cat([p[0] for p in parts], dim=-1),
                    torch.cat([p[1] for p in parts], dim=-1))

        d = ring.from_ntt(_stack([
            piecewise(fa0, fb0),
            ring.ctx.add(piecewise(fa0, fb1), piecewise(fa1, fb0)),
            piecewise(fa1, fb1)]))
        nb = min(a.noise_budget, b.noise_budget) - (math.log2(n) + 5.0)
        return Ciphertext(c0=_row(d, 0), c1=_row(d, 1), c2=_row(d, 2),
                          noise_budget=nb, key_id=a.key_id)


class StreamingAccumulator:
    """Bounded-memory homomorphic fold over a ballot stream
    (CiphertextStreamProcessor, streaming_processor.h:302-420)."""

    def __init__(self, engine: EncryptionEngine, batch_size: int = 64,
                 progress: Optional[Callable[[int], None]] = None):
        self.engine = engine
        self.batch_size = batch_size
        self.progress = progress
        self._pending: list = []
        self._acc: Optional[Ciphertext] = None
        self._count = 0

    def push(self, ct: Ciphertext):
        self._pending.append(ct)
        self._count += 1
        if len(self._pending) >= self.batch_size:
            self._flush()

    def _flush(self):
        if not self._pending:
            return
        batch_sum = self.engine.batch_add(self._pending) \
            if len(self._pending) > 1 else self._pending[0]
        self._acc = batch_sum if self._acc is None \
            else self.engine.add(self._acc, batch_sum)
        self._pending = []
        if self.progress:
            self.progress(self._count)

    def result(self) -> Ciphertext:
        self._flush()
        if self._acc is None:
            raise ValueError("empty stream")
        return self._acc

    @property
    def count(self) -> int:
        return self._count


class CiphertextStreamProcessor:
    """Asynchronous ciphertext stream processor with real backpressure
    (streaming_processor.h:302-422 CiphertextStreamProcessor).

    A worker thread drains a BOUNDED queue into a StreamingAccumulator;
    `push` blocks once `max_in_flight` items are pending, so a fast
    producer cannot grow memory without bound.  Device work stays on the
    single worker thread (the accumulator state is not thread-safe), mirroring the reference's single consumer
    with condition-variable backpressure.
    """

    def __init__(self, engine: EncryptionEngine, batch_size: int = 64,
                 max_in_flight: int = 256,
                 progress: Optional[Callable[[int], None]] = None):
        self._acc = StreamingAccumulator(engine, batch_size=batch_size,
                                         progress=progress)
        self._q: queue.Queue = queue.Queue(maxsize=max_in_flight)
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._acc.push(item)
            except BaseException as e:       # propagate to the producer
                self._error = e
                return
            finally:
                self._q.task_done()

    def push(self, ct: Ciphertext, timeout: Optional[float] = None):
        """Blocks when the in-flight window is full (backpressure)."""
        if self._error is not None:
            raise RuntimeError("stream worker failed") from self._error
        self._q.put(ct, timeout=timeout)

    @property
    def pending(self) -> int:
        return self._q.qsize()

    def result(self) -> Ciphertext:
        """Close the stream, join the worker, return the accumulated sum."""
        self._q.put(None)
        self._worker.join()
        if self._error is not None:
            raise RuntimeError("stream worker failed") from self._error
        return self._acc.result()

    @property
    def count(self) -> int:
        return self._acc.count


def _same(x, y) -> bool:
    """Limb planes equal bit for bit."""
    return torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


class StreamingEquivalenceVerifier:
    """Streamed result must equal the direct computation bit-for-bit
    (streaming_processor.h:422)."""

    @staticmethod
    def verify_add(engine: EncryptionEngine, cts: list,
                   batch_size: int = 4) -> bool:
        direct = engine.batch_add(cts)
        acc = StreamingAccumulator(engine, batch_size=batch_size)
        for ct in cts:
            acc.push(ct)
        streamed = acc.result()
        return _same(direct.c0, streamed.c0) and _same(direct.c1,
                                                       streamed.c1)

    @staticmethod
    def verify_multiply(engine: EncryptionEngine, a: Ciphertext,
                        b: Ciphertext, chunk_size: int = 64) -> bool:
        """Chunked tensor product must equal multiply_raw bit-for-bit
        (the reference's equivalence verifier covers multiply,
        streaming_processor.h:422)."""
        direct = engine.multiply_raw(a, b)
        chunked = ChunkedCiphertextProcessor(
            engine, chunk_size).chunked_multiply_raw(a, b)

        return (_same(direct.c0, chunked.c0)
                and _same(direct.c1, chunked.c1)
                and _same(direct.c2, chunked.c2))


class ResumableUpload:
    """Resumable chunked transfer of a serialized blob (ballots, keys).

    The reference requires resumable ballot uploads (requirements.md:304,
    requirement 16.2) but ships no implementation; this is the in-code
    resilience piece of SURVEY.md §5.3.  Protocol: the payload splits into
    fixed-size chunks, each sent with (upload_id, index, offset, CRC32);
    the receiver acknowledges contiguous progress, so after ANY
    interruption the sender queries `receiver.offset(upload_id)` and
    resumes from the first unacknowledged byte.  Chunk CRCs reject
    corruption at the chunk level (retransmit one chunk, not the blob);
    the assembled payload re-verifies end-to-end through the serializer's
    header checksum when it is a serializer blob.
    """

    def __init__(self, chunk_size: int = 1 << 16):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.chunk_size = chunk_size

    # -- sender side ----------------------------------------------------------
    def chunks(self, upload_id: str, payload: bytes, start_offset: int = 0):
        """Yield (upload_id, index, offset, crc32, data) from an offset."""
        idx0 = start_offset // self.chunk_size
        if start_offset % self.chunk_size:
            raise ValueError("resume offset must be chunk-aligned")
        for i in range(idx0, -(-len(payload) // self.chunk_size)):
            off = i * self.chunk_size
            data = payload[off: off + self.chunk_size]
            yield (upload_id, i, off, zlib.crc32(data), data)


class ResumableUploadReceiver:
    """Receiver half: per-upload contiguous-progress tracking + assembly."""

    def __init__(self, chunk_size: int = 1 << 16):
        self.chunk_size = chunk_size
        self._parts: dict = {}       # upload_id -> {index: bytes}
        self._done: dict = {}

    def offset(self, upload_id: str) -> int:
        """First byte the sender still needs to send (resume point)."""
        parts = self._parts.get(upload_id, {})
        i = 0
        while i in parts:
            i += 1
        return i * self.chunk_size

    def receive(self, chunk) -> bool:
        """Accept one chunk; False (not an exception) on CRC mismatch so
        the sender retransmits just that chunk."""
        upload_id, idx, off, crc, data = chunk
        if zlib.crc32(data) != crc:
            return False
        if off != idx * self.chunk_size:
            return False
        self._parts.setdefault(upload_id, {})[idx] = data
        return True

    def complete(self, upload_id: str, total_size: int) -> bytes:
        parts = self._parts.get(upload_id, {})
        n = -(-total_size // self.chunk_size)
        missing = [i for i in range(n) if i not in parts]
        if missing:
            raise ValueError(f"upload incomplete: missing chunks {missing}")
        blob = b"".join(parts[i] for i in range(n))
        if len(blob) != total_size:
            raise ValueError("assembled size mismatch")
        return blob
