"""Double-buffered host -> device prefetch.

Counterpart of ``theanompi_tpu/data/prefetch.py``.  A loader thread
pulls numpy batches from the host iterator, puts each array in pinned
host memory and starts its copy to the card with ``non_blocking=True``
on a side CUDA stream, so the copy of batch t+1 overlaps the step on
batch t.  The consumer makes its current stream wait for the side
stream (``wait_stream``) before it uses a batch, and marks each tensor
with ``record_stream``, so the caching allocator never hands the
memory of a batch still in use to another.  The thread only copies:
all training work stays on the consumer's thread.  On the CPU the
arrays are wrapped as tensors and nothing is pinned.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


class DevicePrefetcher:
    """Wrap a host batch iterator; yield device batches (tuples of
    tensors), two staged ahead.  ``close()`` (or leaving the ``with``
    block) stops the thread early."""

    _SENTINEL = object()

    def __init__(self, host_batches: Iterable, device: torch.device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            # the loader thread selects the card by index: take the
            # consumer's current one
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._worker, args=(iter(host_batches),), daemon=True,
            name="prefetch-loader")
        self._thread.start()

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self._cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _worker(self, it: Iterator) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                try:
                    batch = next(it)
                except StopIteration:
                    break
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        staged = tuple(self._stage(a) for a in batch)
                else:
                    staged = tuple(self._stage(a) for a in batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced to the consumer thread
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        if self._cuda:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self._stream)
            for t in item:
                t.record_stream(current)
        return item

    def close(self) -> None:
        self._stop.set()
        try:  # drain so the worker unblocks
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
