"""Async device-prefetching input pipeline.

The reference hides data-marshaling latency with Polyester threads inside
``DACLoader.load!`` (/root/reference/src/data/criteo.jl:284-344) and hides
slow-tier writes with the BatchUpdater producer/consumer pipeline
(src/model/embedding_update.jl, SURVEY §2.4 P4).  Here the equivalent is
keeping the host→device transfer of batch N+1..N+k in flight while the
device runs step N:

* a background thread pulls host batches from the source iterator and
  ``jax.device_put``s them (device transfers are async in JAX — the put
  returns immediately and the copy overlaps device compute);
* a bounded queue (``size`` batches) provides backpressure so at most
  ``size`` batches of device memory are held by the pipeline;
* iteration order and contents are exactly the source's (pure plumbing).

Works with any iterator of pytrees (numpy or jax arrays) — DACLoader,
synthetic.batch_stream, etc.  Pass a ``jax.sharding.Sharding`` to place
batches for the multi-chip path (batch-sharded over the mesh).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional

import jax


def _batch_dim(spec) -> int:
    """The batch axis index in a batch PartitionSpec: the first sharded
    dim (block-stacked batches are P(None, axes) — dim 1)."""
    for i, e in enumerate(spec):
        if e is not None:
            return i
    raise ValueError(f"unsharded batch spec {spec}")


def _put_process_local(batch, sharding, global_batch: int):
    """Assemble a GLOBAL batch array from this process's local rows (the
    multi-host feeding path): ``batch`` holds only the rows
    ``mesh.local_batch_rows`` told the source to produce; the sharding's
    index map stitches every process's slice into one global array."""
    dim = _batch_dim(sharding.spec)

    def put(x):
        gshape = list(x.shape)
        gshape[dim] = global_batch
        return jax.make_array_from_process_local_data(
            sharding, x, global_shape=tuple(gshape))

    return jax.tree.map(put, batch)


def device_prefetch(source: Iterable, *, size: int = 2,
                    sharding: Optional[Any] = None,
                    global_batch: Optional[int] = None) -> Iterator:
    """Yield batches from ``source``, transferred to device ``size`` ahead.

    Exceptions in the source propagate to the consumer at the point of
    iteration.  The background thread is a daemon: abandoning the iterator
    mid-stream leaks at most ``size`` queued batches, no join required.

    Multi-process (``jax.process_count() > 1``): pass ``global_batch`` (the
    GLOBAL batch size) and a batch ``sharding``; the source must yield only
    this process's local rows and the put assembles global arrays via
    ``jax.make_array_from_process_local_data``.
    """
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    multiproc = jax.process_count() > 1
    if multiproc and (sharding is None or global_batch is None):
        raise ValueError("multi-process feeding needs sharding + "
                         "global_batch (see run.py --distributed wiring)")
    q: "queue.Queue" = queue.Queue()
    # the transfer slot is reserved BEFORE device_put, so at most ``size``
    # batches have transfers issued / HBM pinned at any time (a bounded
    # queue alone would let a size+1-th put() run before q.put blocks)
    slots = threading.Semaphore(size)

    class _End:  # sentinel (carries the producer's exception, if any)
        def __init__(self, exc):
            self.exc = exc

    def put(batch):
        sh = sharding(batch) if callable(sharding) else sharding
        if multiproc:
            return _put_process_local(batch, sh, global_batch)
        if sh is not None:
            return jax.device_put(batch, sh)
        return jax.device_put(batch)

    def producer():
        try:
            for batch in source:
                slots.acquire()
                q.put(put(batch))
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            q.put(_End(e))
            return
        q.put(_End(None))

    thread = threading.Thread(target=producer, daemon=True,
                              name="dlrm-prefetch")
    thread.start()

    while True:
        item = q.get()
        if isinstance(item, _End):
            if item.exc is not None:
                raise item.exc
            return
        slots.release()  # consumer took ownership; free a transfer slot
        yield item
