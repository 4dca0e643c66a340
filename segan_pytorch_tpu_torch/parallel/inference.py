"""Chunk-parallel enhancement of one long utterance over several devices: the
counterpart of ``segan_pytorch_tpu/parallel/inference.py``, with copies of its numpy
``_bucket_pow2``, ``chunk_grid`` and ``overlap_add``.

``enhance_sharded`` splits the utterance's chunk grid over a list of devices, one G
replica on each: the chunks are independent rows (G in eval mode), so the devices need
no communication, and the de-emphasis runs on the host after the rows come back.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

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


def enhance_sharded(segan, wav: np.ndarray, devices: Optional[Sequence] = None,
                    overlap: float = 0.0, z: Optional[np.ndarray] = None) -> np.ndarray:
    """Enhance one normalized, pre-emphasized waveform with its chunk grid split over
    `devices` (default: the engine's device), a copy of the engine's G (in its compute
    dtype) on each; the JAX ``enhance_sharded`` (``:62-101``) with a list of devices for
    its mesh. The grid is padded with zero rows to a power of two, then to a multiple of
    the device count, and each device takes an equal run of rows. Every chunk takes one
    z row: `z` (1, T', z_dim) when given, else a draw seeded by ``cfg.seed``. Returns
    the de-emphasized enhanced wav."""
    import torch

    from ..ops.signal import de_emphasize_np

    devices = [torch.device(d) for d in (devices or [segan.device])]
    wav = np.asarray(wav, np.float32).reshape(-1)
    S = segan.cfg.slice_size
    grid, hop, n_chunks = chunk_grid(wav, S, overlap)
    n_dev = len(devices)
    n_padded = max(_bucket_pow2(n_chunks), n_dev)
    n_padded = -(-n_padded // n_dev) * n_dev
    x = np.zeros((n_padded, S, 1), np.float32)
    x[:n_chunks] = grid
    if segan.G.no_z:
        zrow = None
    elif z is None:
        zrow = segan.G.sample_z((1, S, 1), torch.Generator().manual_seed(segan.cfg.seed))
    else:
        z = torch.as_tensor(np.asarray(z, np.float32))
        zrow = z.reshape((1,) + tuple(z.shape[-2:]))
    cdt = segan.compute_dtype
    per = n_padded // n_dev
    parts = []
    with torch.inference_mode():
        for i, dev in enumerate(devices):
            G = copy.deepcopy(segan._g()).to(dev)
            xi = torch.from_numpy(x[i * per:(i + 1) * per]).to(dev, cdt)
            zi = zrow.to(dev, cdt).expand(per, -1, -1) if zrow is not None else None
            parts.append(G(xi, zi))
        out = torch.cat([p.float().cpu() for p in parts])[:n_chunks].numpy()
    merged = overlap_add(out, hop, wav.shape[0]) if overlap > 0 else out.reshape(-1)[
        :wav.shape[0]]
    return de_emphasize_np(merged, segan.preemph)
