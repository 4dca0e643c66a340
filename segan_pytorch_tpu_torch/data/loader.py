"""Threaded, fixed-shape batch loader: ``DataLoader`` of ``segan_pytorch_tpu/data/
loader.py`` for one process, and ``device_prefetch``, its way onto the card.

The loader gives every batch the same shape: the final ragged batch is padded by
repeating its last row and carries a ``mask`` with 0 on those rows, which the masked
BatchNorm and losses leave out. The shuffle is a ``random.Random(seed)`` over the slice
indices, so a seed gives the JAX loader's batches bit for bit. With ``num_workers`` > 1
worker threads build batches ahead and they are emitted in order.

``shuffle_buffer`` > 0 walks the slices through a bounded shuffle buffer instead
(``--shuffle_buffer``) and drops the ragged tail; ``emit_dtype`` (``--loader_dtype``)
casts clean and noisy at collate time, with torch, so that a bfloat16 batch crosses to
the card at 2 bytes a sample. ``shard_id`` / ``num_shards`` load one data shard of a
multi-GPU run: ``batch_size`` stays the global batch, every shard walks the same seeded
shuffle and gathers only its ``batch_size // num_shards`` rows of each padded global
batch (and its part of the global mask), so the shards put together are the one-process
loader's batch bit for bit.
"""
from __future__ import annotations

import collections
import queue
import random as _random
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .se_dataset import collate_batch

DEVICE_KEYS = ("clean", "noisy", "mask", "additive_mask")


def loader_dtype(name: str) -> torch.dtype:
    """The floating torch dtype that ``--loader_dtype`` names ('bfloat16', 'float16',
    'float32', ...); any other name raises, as ``np.dtype`` does in the JAX loader."""
    dtype = getattr(torch, name, None) if isinstance(name, str) else None
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise TypeError(f"--loader_dtype {name!r} is not a floating torch dtype")
    return dtype


def host_float32(v) -> np.ndarray:
    """A host batch's clean or noisy as a float32 numpy array, whatever dtype the loader
    emitted it in (a torch tensor after an ``emit_dtype`` cast; the up-cast is exact)."""
    if torch.is_tensor(v):
        return v.float().numpy()
    return np.asarray(v, np.float32)


def _host_tensor(v) -> torch.Tensor:
    """A batch field as a contiguous CPU tensor: a cast field (already a tensor) in its
    own dtype, a numpy one in fp32."""
    if torch.is_tensor(v):
        return v.contiguous()
    return torch.from_numpy(np.ascontiguousarray(v, np.float32))


def device_prefetch(iterator, device, size: int = 2):
    """Yield each batch with clean, noisy, mask and WSEGAN's additive_mask (those it has)
    as tensors on `device`, copied `size` - 1 batches ahead of use; the rest of the
    batch (names, slice indices) and the host batch, under 'host', pass through. Clean
    and noisy keep the dtype the loader emitted them in (bfloat16 under
    ``--loader_dtype bfloat16``: 2 bytes a sample cross to the card, and the step
    casts on the device); numpy fields go as fp32.

    On a CUDA device the host arrays are put in pinned memory and copied with
    non_blocking=True, so the host enqueues the next batch's copy behind the running
    step and goes on without waiting for the card. The
    pinned tensors of a batch are held until the consumer asks for the batch after it,
    that is until the step that reads them has been enqueued."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def to_device(batch):
        pinned = {k: _host_tensor(batch[k]) for k in DEVICE_KEYS if k in batch}
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
        shuffle_buffer: int = 0,
        shuffle_buffer_mode: str = "sharded",
        emit_dtype: Optional[str] = None,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        """shard_id / num_shards: this loader's data shard of a multi-GPU run (the JAX
        loader's, ``:71-169``): ``batch_size`` is the global batch, which must divide by
        ``num_shards``; the loader emits rows [shard_id * Bs, (shard_id + 1) * Bs) of
        each padded global batch, Bs = batch_size // num_shards, with that part of the
        global mask (the padding rows of a ragged batch sit on the last shards), and
        ``len`` counts its batches.

        shuffle_buffer > 0: a streaming shuffle through a bounded buffer of that many
        slices in place of the shuffled index list, as the JAX loader's: each epoch
        draws a new ``random.Random`` from the loader's, the buffer fills in index order
        and each batch row is a random pick from it (FIFO without ``shuffle``), the
        ragged tail is dropped and every mask is all ones. 'sharded' walks this shard's
        strided indices (shard_id::num_shards) through its own buffer, in local
        batches; 'global' replays the one walk over every index in global batches and
        keeps this shard's rows, so its shards put together are one loader's batch.

        emit_dtype: cast clean and noisy to this torch dtype (``loader_dtype``) at
        collate time; they are then CPU tensors, not numpy arrays (numpy has no
        bfloat16), and the mask stays fp32."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.rng = _random.Random(seed)
        self.prefetch = prefetch
        self.shuffle_buffer = int(shuffle_buffer)
        if shuffle_buffer_mode not in ("sharded", "global"):
            raise ValueError(f"shuffle_buffer_mode must be 'sharded' or "
                             f"'global', got {shuffle_buffer_mode!r}")
        self.shuffle_buffer_mode = shuffle_buffer_mode
        self.emit_dtype = loader_dtype(emit_dtype) if emit_dtype else None
        if num_shards > 1 and batch_size % num_shards:
            raise ValueError(f"global batch_size {batch_size} must divide by num_shards "
                             f"{num_shards}")
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} out of range [0, {num_shards})")
        self.shard_id, self.num_shards = shard_id, num_shards
        self.local_batch = batch_size // num_shards
        self.rows = slice(shard_id * self.local_batch, (shard_id + 1) * self.local_batch)

    def __len__(self):
        n = len(self.dataset)
        if self.shuffle_buffer > 0:
            if self.shuffle_buffer_mode == "global":
                return n // self.batch_size
            return (n // self.num_shards) // self.local_batch
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            yield idx[i : i + self.batch_size]

    def _make_batch(self, indices):
        n_valid = len(indices)
        mask = np.zeros((self.batch_size,), np.float32)
        mask[:n_valid] = 1.0
        if self.num_shards > 1:
            # this shard's rows of the padded global batch: the shards put together
            # are the one-process loader's batch
            rows = (list(indices) + [indices[-1]] * (self.batch_size - n_valid))[self.rows]
            batch = self._gather(rows)
            batch["mask"] = mask[self.rows]
            return self._cast(batch)
        batch = self._gather(indices)
        pad = self.batch_size - n_valid
        if pad > 0:
            for k, v in list(batch.items()):
                if isinstance(v, np.ndarray):
                    batch[k] = np.concatenate([v] + [v[-1:]] * pad, axis=0)
                elif isinstance(v, list):
                    batch[k] = v + [v[-1]] * pad
        batch["mask"] = mask
        return self._cast(batch)

    def _cast(self, batch: dict) -> dict:
        """clean and noisy in ``emit_dtype`` (round to nearest even), as CPU tensors."""
        if self.emit_dtype is not None:
            for k in ("clean", "noisy"):
                if k in batch:
                    batch[k] = torch.from_numpy(
                        np.ascontiguousarray(batch[k], np.float32)).to(self.emit_dtype)
        return batch

    def _gather(self, indices):
        """The dataset's native batch gather when it has one that works, else its
        slices one by one."""
        gather = getattr(self.dataset, "gather_batch", None)
        batch = gather(indices) if gather is not None else None
        if batch is not None:
            return batch
        return collate_batch([self.dataset[i] for i in indices])

    def _buffered_indices(self):
        """The rows of each batch of the streaming shuffle (the JAX loader's walk): a new
        stream each epoch, swap-pop picks from a buffer of ``shuffle_buffer`` slices, or
        FIFO without ``shuffle``; ``len(self)`` batches. 'sharded': this shard's strided
        indices in local batches; 'global': every index in global batches."""
        rnd = _random.Random(self.rng.random())  # a new stream each epoch
        if self.shuffle_buffer_mode == "global":
            seq, emit_size = range(len(self.dataset)), self.batch_size
        else:
            seq = range(self.shard_id, len(self.dataset), self.num_shards)
            emit_size = self.local_batch
        n_batches = len(self)
        buf: list = []
        out: list = []
        emitted = 0

        def pop_random():
            j = rnd.randrange(len(buf))
            buf[j], buf[-1] = buf[-1], buf[j]
            return buf.pop()

        for i in seq:
            buf.append(i)
            if len(buf) >= max(self.shuffle_buffer, 1):
                out.append(pop_random() if self.shuffle else buf.pop(0))
                if len(out) == emit_size:
                    yield out
                    out = []
                    emitted += 1
                    if emitted == n_batches:
                        return
        while buf and emitted < n_batches:
            out.append(pop_random() if self.shuffle else buf.pop(0))
            if len(out) == emit_size:
                yield out
                out = []
                emitted += 1

    def __iter__(self) -> Iterator[dict]:
        if self.shuffle_buffer > 0:
            for rows in self._buffered_indices():
                if self.shuffle_buffer_mode == "global":
                    rows = rows[self.rows]
                batch = self._gather(rows)
                batch["mask"] = np.ones((self.local_batch,), np.float32)
                yield self._cast(batch)
            return
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
