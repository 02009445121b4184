"""Composable ciphertext stream pipelines (a copy of
node_fhe_accelerate_tpu/core/streams.py, pure Python; the port keeps its
own).

Twin of the reference's Node stream classes
(src/streaming/node-streams.ts:27-352: CiphertextReadableStream,
CiphertextWritableStream, CiphertextTransformStream,
CiphertextAdditionStream, EncryptionStream, asyncIterable adapters).

Design deviation, deliberate: Node streams push ONE ciphertext per
``_transform`` callback with an event-loop backpressure protocol; per-item
dispatch serializes the device.  Here every stage is a plain pull-based
iterator transformer that gathers items into micro-batches and issues one
batched device call per batch; backpressure is the Python
iterator protocol itself (a stage pulls from upstream only when downstream
asks).  ``pipeline()`` composes stages exactly like Node's ``.pipe()``.

Async ingestion with bounded queues lives in
``core.streaming.CiphertextStreamProcessor``; these classes are the
pipeline/transform surface.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional

__all__ = [
    "CiphertextReadable", "CiphertextWritable", "TransformStream",
    "AdditionStream", "EncryptionStream", "DecryptionStream", "pipeline",
]


class CiphertextReadable:
    """Pull source over an in-memory list (CiphertextReadableStream,
    node-streams.ts:27-82).  ``high_water_mark`` is accepted for parity but
    unused: pull iteration never buffers ahead."""

    def __init__(self, ciphertexts: Iterable, high_water_mark: int = 16):
        self._items = ciphertexts
        self.high_water_mark = high_water_mark

    def __iter__(self) -> Iterator:
        yield from self._items


class CiphertextWritable:
    """Collecting sink (CiphertextWritableStream, node-streams.ts:84-132):
    gathers results, fires an optional per-item callback, exposes counts."""

    def __init__(self, on_item: Optional[Callable[[Any], None]] = None):
        self.results: list = []
        self._on_item = on_item

    def write(self, item) -> None:
        self.results.append(item)
        if self._on_item is not None:
            self._on_item(item)

    def consume(self, items: Iterable) -> "CiphertextWritable":
        for it in items:
            self.write(it)
        return self

    @property
    def count(self) -> int:
        return len(self.results)


class TransformStream:
    """Micro-batched map stage (CiphertextTransformStream,
    node-streams.ts:134-192).

    ``fn`` receives a LIST of up to ``batch_size`` items and returns a list
    of outputs — one device dispatch per micro-batch.  With batch_size=1 it
    degrades to the reference's per-item shape (fn still gets a 1-list)."""

    def __init__(self, fn: Callable[[list], list], batch_size: int = 64,
                 progress: Optional[Callable[[int], None]] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.fn = fn
        self.batch_size = batch_size
        self.progress = progress

    def __call__(self, upstream: Iterable) -> Iterator:
        buf: list = []
        done = 0
        for item in upstream:
            buf.append(item)
            if len(buf) >= self.batch_size:
                out = self.fn(buf)
                done += len(buf)
                if self.progress is not None:
                    self.progress(done)
                buf = []
                yield from out
        if buf:
            out = self.fn(buf)
            done += len(buf)
            if self.progress is not None:
                self.progress(done)
            yield from out


class AdditionStream:
    """Running homomorphic tally (CiphertextAdditionStream,
    node-streams.ts:194-278): consumes ciphertexts, emits the running sum
    after every micro-batch (the reference emits after every item).

    ``add_many`` should reduce a list of ciphertexts (+ optional carry) to
    one — e.g. ``FHEEngine.batch_add`` (tree reduction, one dispatch)."""

    def __init__(self, add_many: Callable[[list], Any], batch_size: int = 16,
                 emit_partials: bool = True):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.add_many = add_many
        self.batch_size = batch_size
        self.emit_partials = emit_partials

    def __call__(self, upstream: Iterable) -> Iterator:
        acc = None
        buf: list = []

        def flush():
            nonlocal acc, buf
            items = ([acc] if acc is not None else []) + buf
            acc = items[0] if len(items) == 1 else self.add_many(items)
            buf = []
            return acc

        for ct in upstream:
            buf.append(ct)
            if len(buf) >= self.batch_size:
                partial = flush()
                if self.emit_partials:
                    yield partial
        if buf:
            partial = flush()
            if self.emit_partials:
                yield partial
        if not self.emit_partials and acc is not None:
            yield acc


class EncryptionStream(TransformStream):
    """Plaintext -> ciphertext stage (EncryptionStream,
    node-streams.ts:280-341), micro-batched: one ``batch_encrypt`` dispatch
    per ``batch_size`` plaintexts."""

    def __init__(self, batch_encrypt: Callable[[list], list],
                 batch_size: int = 64,
                 progress: Optional[Callable[[int], None]] = None):
        super().__init__(batch_encrypt, batch_size, progress)


class DecryptionStream(TransformStream):
    """Ciphertext -> plaintext stage (the reference pipes through
    ``FHEEngine.decrypt`` per item; here one batched decrypt per chunk)."""

    def __init__(self, batch_decrypt: Callable[[list], list],
                 batch_size: int = 64,
                 progress: Optional[Callable[[int], None]] = None):
        super().__init__(batch_decrypt, batch_size, progress)


def pipeline(source: Iterable, *stages) -> Iterator:
    """Compose stages left-to-right, like chained ``.pipe()`` calls:
    ``pipeline(values, EncryptionStream(...), AdditionStream(...))``."""
    it: Iterable = iter(source)
    for stage in stages:
        it = stage(it)
    return iter(it)
