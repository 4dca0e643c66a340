"""Chunk grid and overlap-add for long-utterance enhancement (numpy only): copies of
``_bucket_pow2``, ``chunk_grid`` and ``overlap_add`` of
``segan_pytorch_tpu/parallel/inference.py``."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _bucket_pow2(n: int) -> int:
    """The next power of two >= n (1 for n <= 1): the row count by which the serving
    batchers measure a pass against their budget."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


def chunk_grid(wav: np.ndarray, slice_size: int, overlap: float = 0.0
               ) -> Tuple[np.ndarray, int, int]:
    """Split a 1-D wav into a (N, slice_size, 1) grid. overlap in [0, 0.5)."""
    T = wav.shape[0]
    hop = int(slice_size * (1.0 - overlap)) or slice_size
    n_chunks = max(1, -(-max(T - slice_size, 0) // hop) + 1)
    total = (n_chunks - 1) * hop + slice_size
    buf = np.zeros((total,), np.float32)
    buf[:T] = wav
    idx = np.arange(n_chunks)[:, None] * hop + np.arange(slice_size)[None, :]
    return buf[idx][..., None], hop, n_chunks


def overlap_add(chunks: np.ndarray, hop: int, T: int) -> np.ndarray:
    """Cross-fade overlapping enhanced chunks (N, S, 1) back into one waveform."""
    n, S = chunks.shape[0], chunks.shape[1]
    out = np.zeros(((n - 1) * hop + S,), np.float64)
    wsum = np.zeros_like(out)
    if hop >= S:
        win = np.ones((S,))
    else:
        # nonzero-endpoint hann ramps so every sample keeps positive total weight
        ramp = np.hanning(2 * (S - hop) + 2)[1:-1]
        win = np.ones((S,))
        win[: S - hop] = ramp[: S - hop]
        win[hop:] = ramp[S - hop:]
    for i in range(n):
        out[i * hop: i * hop + S] += chunks[i, :, 0] * win
        wsum[i * hop: i * hop + S] += win
    out = out / np.maximum(wsum, 1e-8)
    return out[:T].astype(np.float32)
