"""F0 (pitch) evaluation of the WSEGAN dewhispering research path: a copy of
``segan_pytorch_tpu/metrics/f0.py`` (numpy only), pinned to it by
``tests/test_torch_aux_data.py``. wav -> lf0 goes through ``data/aco.py`` ``wav2lf0``:
the ``ahocoder16_64`` binary when it is on PATH, else the built-in autocorrelation
tracker.

``F0Evaluator``'s pool is spawned, never forked: the parent may hold a CUDA context and
loader threads (as for ``evaluate``'s pool, ``models/segan.py``). Whoever makes a pool
ends it (``ev.pool.terminate()``).
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Optional, Tuple

import numpy as np

from ..data.aco import wav2lf0


def KLD(mean_p, std_p, mean_g, std_g):
    """KL divergence of two normals."""
    var_p = std_p**2
    var_g = std_g**2
    num = var_p + (mean_p - mean_g) ** 2
    return np.log(std_g / std_p + 1e-22) + (num / (2 * var_g + 1e-22)) - 0.5


def compute_MAE(v_lf0: np.ndarray, v_ref_lf0: np.ndarray, mask: np.ndarray):
    """Masked mean absolute error in linear F0, per row."""
    v_lf0 = np.atleast_2d(v_lf0)
    v_ref_lf0 = np.atleast_2d(v_ref_lf0)
    mask = np.atleast_2d(mask)
    L = min(mask.shape[1], v_lf0.shape[1], v_ref_lf0.shape[1])
    v_lf0, v_ref_lf0, mask = v_lf0[:, :L], v_ref_lf0[:, :L], mask[:, :L]
    abs_dif = np.abs(np.exp(v_lf0) - np.exp(v_ref_lf0)) * mask
    return np.sum(abs_dif, axis=1) / np.maximum(np.sum(mask, axis=1), 1e-12)


def compute_accuracy(uv: np.ndarray, ref_uv: np.ndarray):
    """Voicing-decision accuracy, per row."""
    uv = np.atleast_2d(uv)
    ref_uv = np.atleast_2d(ref_uv)
    L = min(uv.shape[1], ref_uv.shape[1])
    return np.mean((uv[:, :L] == ref_uv[:, :L]).astype(np.float32), axis=1)


def _wav2lf0_job(wav):
    return wav2lf0(np.asarray(wav, np.float32))


class F0Evaluator:
    """Batch F0 evaluation: the KLD of the voiced-lf0 distributions, the MAE and the U/V
    accuracy of each row against its reference. With ``num_proc`` > 1 the lf0 tracks are
    taken on a spawned pool of that many workers, made at the first call."""

    def __init__(self, f0_gtruth_dir: Optional[str] = None, num_proc: int = 4):
        if f0_gtruth_dir is not None:
            # upstream raises NotImplementedError here too
            raise NotImplementedError(
                "preloaded F0 ground-truth dirs are not supported (as in the ref)")
        self.num_proc = num_proc
        self.pool: Optional[mp.pool.Pool] = None

    def _extract(self, wavs: np.ndarray):
        if self.num_proc > 1:
            if self.pool is None:
                self.pool = mp.get_context("spawn").Pool(self.num_proc)
            return self.pool.map(_wav2lf0_job, list(wavs))
        return [_wav2lf0_job(w) for w in wavs]

    def compute_KLD(self, v_lf0: np.ndarray, v_ref_lf0: np.ndarray):
        """Per-utterance distribution KLD."""
        mean_p = v_lf0.mean(axis=1)
        std_p = v_lf0.std(axis=1, ddof=1)
        mean_g = v_ref_lf0.mean(axis=1)
        std_g = v_ref_lf0.std(axis=1, ddof=1)
        return KLD(mean_p, std_p, mean_g, std_g), (std_p, std_g)

    def __call__(self, wavs: np.ndarray, ref_wavs: np.ndarray = None,
                 seqlens=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """wavs and ref_wavs (B, T) -> (KLD of the rows whose lf0 varies, MAE (B,),
        accuracy (B,)); the MAE counts the reference's voiced frames."""
        if ref_wavs is None:
            raise ValueError("F0Evaluator needs ref_wavs")
        wavs = np.asarray(wavs)
        ref_wavs = np.asarray(ref_wavs)
        if wavs.ndim != 2 or wavs.shape != ref_wavs.shape:
            raise ValueError(f"wavs and ref_wavs must be (B, T) of one shape, got "
                             f"{wavs.shape} and {ref_wavs.shape}")
        res = self._extract(wavs)
        ref_res = self._extract(ref_wavs)
        ilf0s = np.stack([r[0] for r in res])
        uvs = np.stack([r[1] for r in res])
        ref_ilf0s = np.stack([r[0] for r in ref_res])
        ref_uvs = np.stack([r[1] for r in ref_res])
        mask = ref_uvs
        kld, (std_p, _) = self.compute_KLD(ilf0s, ref_ilf0s)
        mae = compute_MAE(ilf0s, ref_ilf0s, mask)
        acc = compute_accuracy(uvs, ref_uvs)
        kld = kld[std_p > 0]  # predictions of zero spread dropped
        return kld, mae, acc
