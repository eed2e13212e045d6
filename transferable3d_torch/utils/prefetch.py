"""Background-thread batch prefetcher (host -> device overlap).

Port of `transferable3d_tpu/utils/prefetch.py`: the provider runs in a
daemon thread and fills a bounded queue with batches already on the
device, so host preparation, the host-to-device copy and the step run
against each other. A producer's exception is raised in the consumer.

The default `device_put` is `to_device`: on the card each array goes
through pinned host memory and a non-blocking copy on a side stream of
the iterator's own. The producer waits for its copies to finish before
it lets go of the pinned buffers and records an event a batch; the
consumer's stream waits on that event before the step reads the batch
(and records its use of the tensors, so the allocator does not hand
their memory back to the side stream while the step runs).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from transferable3d_torch import resolve_device


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def to_device(tree, device, stream: Optional[torch.cuda.Stream] = None):
    """numpy arrays and tensors in a dict / list / tuple -> tensors on
    `device` (dtypes kept). On a CUDA device the copies are issued on
    `stream` from pinned host memory and awaited before returning."""
    device = torch.device(device)

    def host(x):
        return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))

    if device.type != "cuda":
        return _map(lambda x: host(x).to(device), tree)

    def put(x):
        x = host(x)
        if x.device.type == "cpu":
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        out = _map(put, tree)
    stream.synchronize()
    return out


class PrefetchIterator:
    """Wrap a batch iterable; yields device-resident batches."""

    _DONE = object()

    def __init__(self, batches: Iterable, buffer_size: int = 3,
                 device_put: Optional[Callable[[Any], Any]] = None,
                 device=None):
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._err: Optional[BaseException] = None
        self._stream = None
        if device_put is None:
            device = resolve_device(device)
            if device.type == "cuda":
                self._stream = torch.cuda.Stream(device)

            def device_put(b):
                return to_device(b, device, self._stream)
        self._device_put = device_put

        def worker():
            try:
                for batch in batches:
                    item = self._device_put(batch)
                    self._q.put((item, None if self._stream is None
                                 else self._stream.record_event()))
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        got = self._q.get()
        if got is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        item, ready = got
        if ready is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(ready)
            for t in _leaves(item):
                if torch.is_tensor(t) and t.is_cuda:
                    t.record_stream(consumer)
        return item


def prefetch(batches: Iterable, buffer_size: int = 3,
             device_put: Optional[Callable[[Any], Any]] = None,
             device=None) -> PrefetchIterator:
    return PrefetchIterator(batches, buffer_size, device_put, device)
