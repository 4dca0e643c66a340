"""Serving's engines: the counterparts of ``segan_pytorch_tpu/utils/serving.py``.

- ``MicroBatcher`` coalesces concurrent enhancement requests into one G forward: the
  requests' chunk grids are concatenated (G in eval mode treats rows independently and
  z is one row per request), one pass answers all of them, and each request's rows are
  joined and de-emphasized as ``SEGAN.generate`` joins them. A WSEGAN or AEWSEGAN engine
  is served through its own ``generate_batch`` (one pass over each utterance padded to a
  multiple of 1024), so a served output is the engine's.
- ``WindowBatcher`` coalesces the window forwards of concurrent streaming sessions
  with the same window length into one G forward; each session's z stays on the device
  and the batch's z is concatenated there.
- ``StreamingEnhancer`` enhances audio fed in pieces of any size with hann cross-faded
  windows, pre-emphasis and de-emphasis running as causal filters across ``feed()``
  calls: the concatenated output equals the offline ``chunk_grid`` + ``overlap_add``
  path with the same window, hop and z. A sample is final once the next window can no
  longer touch it: at most window + hop samples of input, plus one forward, late.

Both batchers count a pass's rows as the JAX ones do, rounded up to a power of two
(``_bucket_pow2``), so that one queue of requests coalesces into the same passes. Unlike
the JAX ones they run only the real rows: eager PyTorch has no compiled shapes to bound,
and zero rows would be work for nothing. The adaptive budget's latency estimate is then
per row that ran, and a pass counts as warm once a pass of as many rows has run before
(the first pass of a shape also pays the kernels' first loads and cuDNN's plan).

Two worker threads may run G at once (one per batcher). Each batcher builds the
engine's compute-dtype copy of G (``SEGAN._g``) before its worker starts, and the
kernel's weight cache and counters take a lock.

z: a request carries an explicit z row, a ``torch.Generator`` to draw one from (the
server's ``seed=``), or neither, and then draws from the engine's stream
(``SEGAN.z_rng``) in the order its pass takes the requests, as ``generate`` does.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops.signal import de_emphasize_np, div_n_len
from ..parallel.inference import _bucket_pow2, chunk_grid, overlap_add


class _Job:
    __slots__ = ("pwav", "z", "rng", "overlap", "event", "result", "error")

    def __init__(self, pwav, z=None, rng=None, overlap=0.0):
        self.pwav = pwav
        self.z = z
        self.rng = rng
        self.overlap = overlap
        self.event = threading.Event()
        self.result = None
        self.error = None


class _Worker:
    """A queue of jobs served by one thread: ``_drain_locked`` takes a pass's jobs under
    the lock, ``_process`` answers them outside it."""

    name = "worker"

    def __init__(self, segan):
        self.segan = segan
        segan._g()  # the compute-dtype copy of G, built before the worker runs G
        self._queue: list = []
        self._cv = threading.Condition()
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True, name=self.name)
        self._worker.start()

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=5)

    def _submit(self, job, timeout: Optional[float]):
        with self._cv:
            self._queue.append(job)
            self._cv.notify()
        if not job.event.wait(timeout):
            raise TimeoutError(f"{self.name}: request timed out")
        if job.error is not None:
            raise job.error
        return job.result

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    for j in self._queue:
                        j.error = RuntimeError("batcher closed")
                        j.event.set()
                    return
                jobs = self._drain_locked()
            try:
                self._process(jobs)
            except Exception as e:  # answered to every caller of the pass
                for j in jobs:
                    if not j.event.is_set():
                        j.error = e
                        j.event.set()


class MicroBatcher(_Worker):
    """Coalesce concurrent ``generate`` calls into one G forward.

    ``enhance()`` takes the normalized, pre-emphasized waveform and returns the
    de-emphasized enhanced one, as ``generate()[0]`` does. Requests that arrive while a
    pass runs go into the next one (no wait is added: the running pass is the window).
    """

    name = "microbatcher"

    def __init__(self, segan, max_batch_chunks: int = 128,
                 target_batch_seconds: float = 0.0, min_batch_chunks: int = 8):
        """target_batch_seconds > 0 makes the chunk budget adaptive: it follows the
        measured latency per row so that one coalesced pass stays under the target,
        within [min_batch_chunks, max_batch_chunks]. Only warm passes feed the
        estimate (see the module docstring)."""
        self.max_batch_chunks = max_batch_chunks
        self.target_batch_seconds = float(target_batch_seconds)
        self.min_batch_chunks = int(min_batch_chunks)
        self._sec_per_chunk: Optional[float] = None  # EMA over warm passes
        self._warm_buckets: set = set()
        self.batches = 0   # G passes issued
        self.requests = 0  # requests answered
        super().__init__(segan)

    def enhance(self, pwav: np.ndarray, rng: Optional[torch.Generator] = None,
                overlap: float = 0.0, timeout: Optional[float] = 120.0,
                z: Optional[np.ndarray] = None) -> np.ndarray:
        """The enhanced waveform of `pwav`; z from `z`, else drawn from `rng`, else from
        the engine's stream."""
        job = _Job(np.asarray(pwav, np.float32).reshape(-1), z, rng, float(overlap))
        return self._submit(job, timeout)

    @property
    def effective_max_chunks(self) -> int:
        """The chunk budget: fixed, or fitted to the target from the latency estimate."""
        if self.target_batch_seconds <= 0 or not self._sec_per_chunk:
            return self.max_batch_chunks
        fit = int(self.target_batch_seconds / self._sec_per_chunk)
        return max(self.min_batch_chunks, min(self.max_batch_chunks, fit))

    def _drain_locked(self) -> List[_Job]:
        """Queued jobs up to the budget, counted as the JAX batcher counts them: the
        rows rounded up to a power of two."""
        S = self.segan.cfg.slice_size
        budget = self.effective_max_chunks
        jobs, total = [], 0
        while self._queue:
            n = max(1, -(-len(self._queue[0].pwav) // S))
            if jobs and _bucket_pow2(total + n) > budget:
                break
            jobs.append(self._queue.pop(0))
            total += n
        return jobs

    def _measured(self, shape, dt: float, rows: int):
        """Feed a pass's seconds per row into the estimate if its shape ran before."""
        if shape in self._warm_buckets:
            spc = dt / max(rows, 1)
            self._sec_per_chunk = (spc if self._sec_per_chunk is None
                                   else 0.7 * self._sec_per_chunk + 0.3 * spc)
        self._warm_buckets.add(shape)
        self.batches += 1

    def _draw(self, job: _Job, length: int):
        """The job's z as given, or drawn from its generator for an input of `length`
        samples; None leaves the draw to the engine's stream."""
        if job.z is not None or job.rng is None:
            return job.z
        return self.segan.G.sample_z((1, length, 1), job.rng)

    def _process(self, jobs: List[_Job]):
        from ..models.wsegan import WSEGAN

        segan = self.segan
        S = segan.cfg.slice_size
        if isinstance(segan, WSEGAN):
            # WSEGAN and AEWSEGAN enhance an utterance in one pass padded to a multiple
            # of 1024 (upstream's model.py:755-766): their own generate_batch groups the
            # rows by padded length, and None z entries draw from the engine's stream
            zs = [self._draw(j, div_n_len(len(j.pwav), 1024)) for j in jobs]
            t0 = time.perf_counter()
            results = segan.generate_batch([j.pwav for j in jobs], z=zs)
            dt = time.perf_counter() - t0
            # the budget in slice_size rows, as _drain_locked counts them, warm-gated on
            # the set of padded lengths
            lengths = tuple(sorted({div_n_len(len(j.pwav), 1024) for j in jobs}))
            self._measured(lengths, dt, sum(max(1, -(-len(j.pwav) // S)) for j in jobs))
            for j, (wav, _) in zip(jobs, results):
                j.result = wav
                self.requests += 1
                j.event.set()
            return
        grids, metas, zrows = [], [], []
        for j in jobs:
            grid, hop, n_chunks = chunk_grid(j.pwav, S, j.overlap)
            grids.append(grid)
            metas.append((len(j.pwav), hop, n_chunks))
            zrow = segan._z_row(self._draw(j, S))
            if zrow is not None:
                # one z row per request, shared by its chunks, as generate() does
                zrows.append(zrow.expand(n_chunks, -1, -1))
        x = np.concatenate(grids, axis=0)
        zb = torch.cat(zrows, dim=0) if zrows else None
        t0 = time.perf_counter()
        out = segan.infer_G(x, zb).cpu().numpy()
        dt = time.perf_counter() - t0
        self._measured(x.shape[0], dt, x.shape[0])
        row = 0
        for j, (T, hop, n_chunks) in zip(jobs, metas):
            chunks = out[row: row + n_chunks]
            row += n_chunks
            merged = overlap_add(chunks, hop, T) if j.overlap > 0 else chunks.reshape(-1)[:T]
            j.result = de_emphasize_np(merged, segan.preemph)
            self.requests += 1
            j.event.set()


class _WinJob:
    __slots__ = ("wseg", "z", "event", "result", "error")

    def __init__(self, wseg, z):
        self.wseg = wseg
        self.z = z
        self.event = threading.Event()
        self.result = None
        self.error = None


class WindowBatcher(_Worker):
    """Coalesce the window forwards of concurrent ``StreamingEnhancer`` sessions.

    Each session submits one (window, z) pair per hop; the jobs with the head job's
    window length, up to ``max_rows``, go through G as one pass, each session's z as its
    row. Sessions with other window lengths wait for a later pass. A row's result equals
    the session's own (1, S, 1) forward up to the rounding of another batch shape.
    """

    name = "windowbatcher"

    def __init__(self, segan, max_rows: int = 16):
        self.max_rows = int(max_rows)
        self.batches = 0  # G passes issued
        self.windows = 0  # window forwards answered
        super().__init__(segan)

    def warm(self, window: int, max_rows: Optional[int] = None):
        """Run a pass of each power-of-two row count up to `max_rows` at `window`, on the
        caller's thread, so that the first concurrent streams do not pay a shape's first
        run mid-hop."""
        segan = self.segan
        rows, cap = 1, max_rows or self.max_rows
        while rows <= cap:
            z = segan.G.sample_z((rows, window, 1), torch.Generator().manual_seed(0))
            segan.infer_G(np.zeros((rows, window, 1), np.float32), z).cpu()
            rows *= 2

    def enhance_window(self, wseg: np.ndarray, z: Optional[torch.Tensor] = None,
                       timeout: Optional[float] = 120.0) -> np.ndarray:
        """One window's forward, ``infer_G(wseg[None, :, None], z)[0, :, 0]``, in a
        shared pass."""
        return self._submit(_WinJob(np.asarray(wseg, np.float32).reshape(-1), z), timeout)

    def _drain_locked(self) -> List[_WinJob]:
        """Queued jobs with the head job's window length, up to max_rows."""
        S = self._queue[0].wseg.size
        jobs, rest = [], []
        for j in self._queue:
            if len(jobs) < self.max_rows and j.wseg.size == S:
                jobs.append(j)
            else:
                rest.append(j)
        self._queue = rest
        return jobs

    def _process(self, jobs: List[_WinJob]):
        x = np.stack([j.wseg for j in jobs])[..., None]  # (N, S, 1)
        # the sessions' z rows lie on the device already: concatenated there, with no
        # round trip through the host
        zb = None if self.segan.G.no_z else torch.cat([j.z for j in jobs], dim=0)
        out = self.segan.infer_G(x, zb).cpu().numpy()
        self.batches += 1
        self.windows += len(jobs)
        for i, j in enumerate(jobs):
            j.result = out[i, :, 0]
            j.event.set()


class StreamingEnhancer:
    """Incremental enhancement with hann cross-faded windows.

    ``feed(samples)`` takes raw normalized audio ([-1, 1] float) in pieces of any size
    and returns the samples that became final; ``flush()`` zero-pads the tail and returns
    the rest. The window must divide by the product of G's poolings (default: the
    training slice_size).
    """

    def __init__(self, segan, window: Optional[int] = None, overlap: float = 0.25,
                 rng: Optional[torch.Generator] = None,
                 batcher: Optional[WindowBatcher] = None, z: Optional[np.ndarray] = None):
        if not 0.0 <= overlap < 0.5:
            raise ValueError(f"overlap must be in [0, 0.5), got {overlap}")
        if batcher is not None and batcher.segan is not segan:
            raise ValueError("batcher serves a different engine")
        self.batcher = batcher
        self.segan = segan
        S = int(window or segan.cfg.slice_size)
        pool = 1
        for p in segan.G.poolings:
            pool *= p
        if S % pool:
            raise ValueError(f"window {S} must divide by the generator's total "
                             f"pooling {pool}")
        self.S = S
        self.hop = int(S * (1.0 - overlap)) or S
        # one z for the session, shared by every window (a stream is one utterance),
        # put on the device once here
        self._z = None
        if not segan.G.no_z:
            if z is None:
                if rng is None:
                    rng = torch.Generator().manual_seed(segan.cfg.seed)
                z = segan.G.sample_z((1, S, 1), rng)
            self._z = segan._z_row(z).to(segan.device)
        self._pe_buf = np.zeros((0,), np.float32)  # pre-emphasized input
        self._pe_prev = 0.0    # last raw sample (pre-emphasis state)
        self._de_prev = 0.0    # last output sample (de-emphasis state)
        self._n_in = 0         # raw samples fed
        self._next_win = 0     # index of the next window to enhance
        self._canvas = np.zeros((0,), np.float64)
        self._wsum = np.zeros((0,), np.float64)
        self._emitted = 0      # final samples handed back
        if self.hop >= S:
            self._win = np.ones((S,))
        else:
            ramp = np.hanning(2 * (S - self.hop) + 2)[1:-1]
            w = np.ones((S,))
            w[: S - self.hop] = ramp[: S - self.hop]
            w[self.hop:] = ramp[S - self.hop:]
            self._win = w

    @property
    def latency_samples(self) -> int:
        """Worst-case input-to-output latency in samples (plus one forward)."""
        return self.S + self.hop

    def feed(self, samples: np.ndarray) -> np.ndarray:
        x = np.asarray(samples, np.float32).reshape(-1)
        if x.size:
            # streaming pre-emphasis: y[t] = x[t] - c x[t-1] across feed() calls
            c = self.segan.preemph
            shifted = np.concatenate(([self._pe_prev], x[:-1]))
            self._pe_buf = np.concatenate((self._pe_buf, x - np.float32(c) * shifted))
            self._pe_prev = float(x[-1])
            self._n_in += x.size
        return self._advance(final=False)

    def flush(self) -> np.ndarray:
        """Process the zero-padded tail and return everything not yet emitted."""
        return self._advance(final=True)

    def _enhance_window(self, wseg: np.ndarray) -> np.ndarray:
        if self.batcher is not None:
            return self.batcher.enhance_window(wseg, self._z)
        out = self.segan.infer_G(wseg.reshape(1, self.S, 1), self._z)
        return out[0, :, 0].cpu().numpy()

    def _grow(self, upto: int):
        if self._canvas.shape[0] < upto:
            pad = upto - self._canvas.shape[0]
            self._canvas = np.concatenate((self._canvas, np.zeros(pad)))
            self._wsum = np.concatenate((self._wsum, np.zeros(pad)))

    def _advance(self, final: bool) -> np.ndarray:
        S, hop = self.S, self.hop
        while True:
            beg = self._next_win * hop
            have = self._pe_buf.shape[0]
            # chunk_grid's window count: a new window runs only while the ones done do
            # not yet cover the input (the smallest n with (n - 1) hop + S >= T)
            covered = -1 if self._next_win == 0 else (self._next_win - 1) * hop + S
            if covered >= max(self._n_in, 1):
                break
            if not final and have < beg + S:
                break
            wseg = np.zeros((S,), np.float32)
            seg = self._pe_buf[beg: beg + S]
            wseg[: seg.shape[0]] = seg
            enh = self._enhance_window(wseg)
            self._grow(beg + S)
            self._canvas[beg: beg + S] += enh * self._win
            self._wsum[beg: beg + S] += self._win
            self._next_win += 1
        # samples before the next window's start can no longer change
        final_upto = self._n_in if final else min(self._next_win * hop, self._n_in)
        if final_upto <= self._emitted:
            return np.zeros((0,), np.float32)
        self._grow(final_upto)
        seg = (self._canvas[self._emitted: final_upto]
               / np.maximum(self._wsum[self._emitted: final_upto], 1e-8))
        # streaming de-emphasis: y[t] = x[t] + c y[t-1] across emissions, through
        # lfilter's state (zi = c y_prev)
        c = self.segan.preemph
        if c > 0:
            from scipy.signal import lfilter

            out, _ = lfilter([1.0], [1.0, -c], seg, zi=np.asarray([c * self._de_prev]))
            self._de_prev = float(out[-1]) if out.size else self._de_prev
        else:
            out = seg
        self._emitted = final_upto
        return out.astype(np.float32)


__all__ = ["MicroBatcher", "StreamingEnhancer", "WindowBatcher"]
