"""Threaded, fixed-shape batch loader: ``DataLoader`` of ``segan_pytorch_tpu/data/
loader.py`` for one process, and ``device_prefetch``, its way onto the card.

The loader gives every batch the same shape: the final ragged batch is padded by
repeating its last row and carries a ``mask`` with 0 on those rows, which the masked
BatchNorm and losses leave out. The shuffle is a ``random.Random(seed)`` over the slice
indices, so a seed gives the JAX loader's batches bit for bit. With ``num_workers`` > 1
worker threads build batches ahead and they are emitted in order. Left for later: the
sharded multi-host loading, the streaming shuffle buffer and the cast at collate time.
"""
from __future__ import annotations

import collections
import queue
import random as _random
import threading
from typing import Iterator

import numpy as np
import torch

from .se_dataset import collate_batch

DEVICE_KEYS = ("clean", "noisy", "mask")


def device_prefetch(iterator, device, size: int = 2):
    """Yield each batch with clean, noisy and mask (those it has) as fp32 tensors on
    `device`, copied `size` - 1 batches ahead of use; the rest of the batch (names, slice
    indices) and the host batch, under 'host', pass through.

    On a CUDA device the host arrays are put in pinned memory and copied with
    non_blocking=True, so the host enqueues the next batch's copy behind the running
    step and goes on without waiting for the card. The
    pinned tensors of a batch are held until the consumer asks for the batch after it,
    that is until the step that reads them has been enqueued."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def to_device(batch):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
                  for k in DEVICE_KEYS if k in batch}
        if cuda:
            pinned = {k: v.pin_memory() for k, v in pinned.items()}
        out = {k: v for k, v in batch.items() if k not in DEVICE_KEYS}
        out.update({k: v.to(device, non_blocking=cuda) for k, v in pinned.items()})
        out["host"] = batch
        return out, pinned

    buf = collections.deque()
    held = None  # the pinned tensors of the batch last handed out
    for batch in iterator:
        buf.append(to_device(batch))
        if len(buf) >= size:
            out, held = buf.popleft()
            yield out
    while buf:
        out, held = buf.popleft()
        yield out
    del held


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 1,
        seed: int = 0,
        prefetch: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.rng = _random.Random(seed)
        self.prefetch = prefetch

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            yield idx[i : i + self.batch_size]

    def _make_batch(self, indices):
        n_valid = len(indices)
        batch = self._gather(indices)
        pad = self.batch_size - n_valid
        if pad > 0:
            for k, v in list(batch.items()):
                if isinstance(v, np.ndarray):
                    batch[k] = np.concatenate([v] + [v[-1:]] * pad, axis=0)
                elif isinstance(v, list):
                    batch[k] = v + [v[-1]] * pad
        mask = np.zeros((self.batch_size,), np.float32)
        mask[:n_valid] = 1.0
        batch["mask"] = mask
        return batch

    def _gather(self, indices):
        """The dataset's native batch gather when it has one that works, else its
        slices one by one."""
        gather = getattr(self.dataset, "gather_batch", None)
        batch = gather(indices) if gather is not None else None
        if batch is not None:
            return batch
        return collate_batch([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator[dict]:
        batches = list(self._batch_indices())
        if self.num_workers <= 1:
            for b in batches:
                yield self._make_batch(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        lock = threading.Lock()
        stop = threading.Event()
        it = iter(enumerate(batches))
        results = {}
        next_emit = 0

        def worker():
            # workers together produce exactly len(batches) items, then exit; errors
            # are forwarded, and the stop event unblocks q.put when the consumer
            # abandons the iterator early (e.g. evaluate's max_samples break)
            while not stop.is_set():
                with lock:
                    try:
                        i, b = next(it)
                    except StopIteration:
                        return
                try:
                    item = (i, self._make_batch(b), None)
                except Exception as e:  # pragma: no cover - defensive
                    item = (i, None, e)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        emitted = 0
        total = len(batches)
        try:
            # emit in order for determinism
            while emitted < total:
                i, batch, err = q.get()
                if err is not None:
                    raise err
                results[i] = batch
                while next_emit in results:
                    yield results.pop(next_emit)
                    next_emit += 1
                    emitted += 1
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            for t in threads:
                t.join(timeout=1.0)
