"""Host-to-device input prefetching.

PyTorch counterpart of the JAX package's ``data/prefetch.py``: while the
card runs step ``i``, batch ``i+1``'s host-to-device copy is already in
flight, so the transfer rides under the compute instead of on the
critical path.

``prefetch_to_device`` wraps any iterable of nested tuples / lists / dicts
of numpy arrays (or CPU tensors).  A background thread turns each array
into a pinned CPU tensor and issues its ``.to(device, non_blocking=True)``
on a copy stream of its own, then records an event; the consumer makes
its current stream wait on that event and marks every tensor as used on
that stream (``record_stream``), so the caching allocator cannot hand the
buffer to another tensor while a step still reads it.  The order is kept,
an exception of the iterable re-raises at the consumer, and a consumer
that stops early releases the thread and the batches it holds.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.tree import flatten, map_arrays

__all__ = ["prefetch_to_device"]

_SENTINEL = object()


def _as_tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(leaf)) if isinstance(leaf, np.ndarray) \
        else leaf


def prefetch_to_device(
    iterable: Iterable,
    size: int = 2,
    sharding: Optional[object] = None,
    device=None,
) -> Iterator:
    """Iterate ``iterable``, moving each element's arrays to ``device``
    (the card unless ``device="cpu"``, where arrays only become tensors)
    up to ``size`` elements ahead of the consumer.  Other leaves (numbers,
    None) pass through.

    ``sharding``: a ``parallel.mesh.Sharding`` (e.g. the batch half of
    ``data_parallel_sharding(mesh)``) applied to every array leaf before
    its copy, so only this rank's rows travel, to the mesh's device; a
    leaf of lower rank than its spec is copied whole, as in JAX."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    if sharding is not None:
        from online_neural_cdes_tpu_torch.parallel.mesh import Sharding

        if not isinstance(sharding, Sharding):
            raise TypeError("sharding must be a parallel.mesh.Sharding, got "
                            f"{type(sharding).__name__}")
        if device is not None and resolve_device(device) != sharding.mesh.device:
            raise ValueError(f"prefetch_to_device(device={device!r}): the sharding's mesh "
                             f"places this rank's rows on {sharding.mesh.device}")
        device = sharding.mesh.device
        place = sharding.place
    else:
        place = _as_tensor
    device = resolve_device(device)
    buf: queue.Queue = queue.Queue(maxsize=size)
    # Set when the consumer abandons the generator (an exception in the
    # training loop, an early break): the producer must not stay blocked
    # on a full queue, holding device batches.
    stop = threading.Event()

    if device.type == "cuda":
        copy_stream = torch.cuda.Stream(device)

        def put(tree):
            with torch.cuda.stream(copy_stream):
                out = map_arrays(tree, lambda leaf: place(leaf).pin_memory().to(
                    device, non_blocking=True))
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return out, ready
    else:
        def put(tree):
            return map_arrays(tree, lambda leaf: place(leaf).to(device)), None

    def enqueue(item) -> bool:
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            for item in iterable:
                if not enqueue(put(item)):
                    return
        except BaseException as exc:  # re-raised by the consumer
            enqueue((_SENTINEL, exc))
            return
        enqueue((_SENTINEL, None))

    thread = threading.Thread(target=producer, daemon=True, name="prefetch")
    thread.start()

    try:
        while True:
            item, ready = buf.get()
            if item is _SENTINEL:
                if ready is not None:
                    raise ready
                return
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for t in flatten(item)[0]:
                    t.record_stream(stream)
            yield item
    finally:
        # On exhaustion and on abandonment: release the producer and drop
        # the buffered batches so their device memory is freed.
        stop.set()
        while True:
            try:
                buf.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)
