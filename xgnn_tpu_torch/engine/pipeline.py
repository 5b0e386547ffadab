"""Async batch prefetch pipeline.

The port of ``xgnn_tpu/engine/pipeline.py``: a producer thread runs
sample + extract for upcoming batches into a bounded queue while the main
thread trains.  On a CUDA device the producer issues its work on a side
stream.  The consumer's stream waits on an event recorded after each
``produce``, and every tensor handed across is ``record_stream``-ed on the
consumer's stream, so the caching allocator does not reuse its memory while
the consumer may still read it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch


def _tensors(obj):
    """Every tensor inside nested tuples, lists, dicts and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


class _Error:
    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Bounded producer/consumer pipeline.

    ``produce`` runs in a background thread for every item of ``work``;
    results arrive in order by iteration.  An exception in the producer is
    raised in the consumer.  ``depth`` bounds the batches in flight.
    ``close()`` stops and joins the thread.
    """

    _SENTINEL = object()

    def __init__(self, work: Iterable, produce: Callable, depth: int = 2,
                 device: Optional[torch.device] = None):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._work = work
        self._produce = produce
        cuda = device is not None and torch.device(device).type == "cuda"
        self._device = torch.device(device) if cuda else None
        self._stream = None
        if cuda:
            # the producer's reads (graph, tables) are ordered after all work
            # the consumer's stream has queued so far
            self._stream = torch.cuda.Stream(self._device)
            self._stream.wait_stream(torch.cuda.current_stream(self._device))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, x) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                for item in self._work:
                    if self._stop.is_set():
                        return
                    out = self._produce(item)
                    event = None
                    if self._stream is not None:
                        event = torch.cuda.Event()
                        event.record(self._stream)
                    if not self._put((out, event)):
                        return
        except Exception as e:  # raised again in the consumer
            self._put(_Error(e))
            return
        self._put(self._SENTINEL)

    def __iter__(self) -> Iterator:
        while True:
            got = self._q.get()
            if got is self._SENTINEL:
                return
            if isinstance(got, _Error):
                raise got.exc
            out, event = got
            if event is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(event)
                for t in _tensors(out):
                    if t.device.type == "cuda":
                        t.record_stream(consumer)
            yield out

    def close(self):
        self._stop.set()
        self._thread.join()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
