"""The paired clean/noisy slice dataset: ``collate_batch`` and ``SEDataset`` of
``segan_pytorch_tpu/data/se_dataset.py``, copied so that the same corpus and cache give
the same slices (``tests/test_torch_data.py`` holds every batch against the JAX one).

``SEDataset`` slices every pair of wavs at a fractional stride and keeps the slice index
in ``{cache_dir}/{split}_idx2slice.json``; an index that is there is read, not rebuilt.
A batch is gathered by the C++ engine (``data/native.py``) when it can be, else item by
item in Python: both give the same bytes. Left for later: the H5 dataset, the random-chunk
datasets and the on-the-fly noise augmentation (``--noises_dir``).
"""
from __future__ import annotations

import glob
import json
import multiprocessing as mp
import os
import random as _random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.signal import normalize_wave_minmax, pre_emphasize_np, slice_signal_indices
from .wav_io import read_wav_16k, read_wav_raw, wav_num_samples_16k


def _slice_index_job(args) -> List[Tuple[int, int]]:
    path, window_size, stride = args
    # slice indexing needs only the 16 kHz sample count: a RIFF-header read, else a
    # full decode for files that read_wav_16k would resample
    n = wav_num_samples_16k(path)
    if n is None:
        wav, _ = read_wav_16k(path, 16000)
        n = wav.shape[0]
    return slice_signal_indices(n, window_size, stride)


def collate_batch(samples: Sequence[dict]) -> dict:
    """Stack a list of per-slice dicts into a batch dict of numpy arrays, keeping the
    uttname list."""
    out = {
        "uttname": [s["uttname"] for s in samples],
        "clean": np.stack([s["clean"] for s in samples]).astype(np.float32),
        "noisy": np.stack([s["noisy"] for s in samples]).astype(np.float32),
        "slice_idx": np.asarray([s["slice_idx"] for s in samples], np.int32),
    }
    if samples and samples[0].get("pesq") is not None:
        out["pesq"] = np.asarray([s["pesq"] for s in samples], np.float32)
    if samples and samples[0].get("ssnr") is not None:
        out["ssnr"] = np.asarray([s["ssnr"] for s in samples], np.float32)
    return out


class SEDataset:
    """Paired clean/noisy slicing dataset."""

    def __init__(
        self,
        clean_dir: str,
        noisy_dir: str,
        preemph: float,
        cache_dir: str = ".",
        split: str = "train",
        slice_size: int = 2**14,
        stride: float = 0.5,
        max_samples: Optional[int] = None,
        verbose: bool = False,
        slice_workers: int = 2,
        preemph_norm: bool = False,
        random_scale: Sequence[float] = (1,),
        io_threads: int = 0,
    ):
        self.clean_names = sorted(glob.glob(os.path.join(clean_dir, "*.wav")))
        self.noisy_names = sorted(glob.glob(os.path.join(noisy_dir, "*.wav")))
        if verbose:
            print(
                f"Found {len(self.clean_names)} clean names and "
                f"{len(self.noisy_names)} noisy names"
            )
        if len(self.clean_names) != len(self.noisy_names) or len(self.clean_names) == 0:
            raise ValueError("No wav data found! Check your data path please")
        if max_samples is not None:
            self.clean_names = self.clean_names[:max_samples]
            self.noisy_names = self.noisy_names[:max_samples]
        self.cache_dir = cache_dir
        self.slice_size = slice_size
        self.stride = stride
        self.split = split
        self.preemph = preemph
        self.preemph_norm = preemph_norm
        self.random_scale = list(random_scale)
        self.slice_workers = slice_workers
        # native gather thread-pool size; 0 = hardware_concurrency (segan_io.cpp)
        self.io_threads = int(io_threads)
        self._wav_cache: Dict[str, np.ndarray] = {}
        self._native = None  # the C++ engine, False once it cannot be used
        self._path_said = False

        os.makedirs(cache_dir, exist_ok=True)
        index_path = os.path.join(cache_dir, f"{split}_idx2slice.json")
        if not os.path.exists(index_path):
            self._prepare_slicing()
            with open(index_path, "w") as f:
                json.dump(self.idx2slice, f)
        else:
            with open(index_path, "r") as f:
                self.idx2slice = [tuple(t) for t in json.load(f)]
            print(f"Loaded {len(self.idx2slice)} idx2slice items")

    # ------------------------------------------------------------------
    def _prepare_slicing(self):
        """Slice every pair; drop slices shorter than 1024 samples."""
        args_c = [(n, self.slice_size, self.stride) for n in self.clean_names]
        args_n = [(n, self.slice_size, self.stride) for n in self.noisy_names]
        if self.slice_workers and self.slice_workers > 1:
            with mp.get_context("spawn").Pool(self.slice_workers) as pool:
                c_slices = pool.map(_slice_index_job, args_c)
                n_slices = pool.map(_slice_index_job, args_n)
        else:
            c_slices = [_slice_index_job(a) for a in args_c]
            n_slices = [_slice_index_job(a) for a in args_n]
        idx2slice = []
        for w_i, (c_sl, n_sl) in enumerate(zip(c_slices, n_slices)):
            for t_i, (c_ss, n_ss) in enumerate(zip(c_sl, n_sl)):
                if c_ss[1] - c_ss[0] < 1024:
                    continue
                idx2slice.append((w_i, t_i, int(c_ss[0]), int(c_ss[1]),
                                  int(n_ss[0]), int(n_ss[1])))
        self.idx2slice = idx2slice

    def read_wav_file(self, path: str) -> np.ndarray:
        """Normalize, then pre-emphasize (the other way round under preemph_norm)."""
        if path in self._wav_cache:
            return self._wav_cache[path]
        rate, wav = read_wav_raw(path)
        wav = np.asarray(wav)
        if self.preemph_norm:
            wav = pre_emphasize_np(wav.astype(np.float32), self.preemph)
            wav = np.asarray(normalize_wave_minmax(wav))
        else:
            wav = np.asarray(normalize_wave_minmax(wav))
            wav = pre_emphasize_np(wav, self.preemph)
        wav = wav.astype(np.float32)
        # small cache so that a file is not re-read for every slice (loader workers
        # share this dict: tolerate concurrent evictions)
        if len(self._wav_cache) > 64:
            try:
                self._wav_cache.pop(next(iter(self._wav_cache)))
            except (KeyError, StopIteration, RuntimeError):
                pass
        self._wav_cache[path] = wav
        return wav

    def _say_path(self, how: str):
        if not self._path_said:
            self._path_said = True
            print(f"[data] {self.split}: batches gathered {how}")

    # ------------------------------------------------------------------
    def gather_batch(self, indices) -> Optional[dict]:
        """The C++ path: decode, normalize, pre-emphasize and slice a whole batch in a
        thread pool. Returns None when it does not apply (pre-emphasis first, .met
        sidecars, random scaling) or the library is unavailable: callers then take the
        Python path."""
        if self.preemph_norm or self.random_scale != [1]:
            self._say_path("in Python (preemph_norm or random_scale)")
            return None
        if getattr(self, "_has_met", None) is None:
            self._has_met = any(
                glob.glob(os.path.join(os.path.dirname(n), "*.met"))
                for n in self.noisy_names[:1])
        if self._has_met:  # .met sidecars need the python metadata path
            self._say_path("in Python (.met sidecars)")
            return None
        if self._native is None:
            try:
                from .native import NativeAudioEngine

                self._native = NativeAudioEngine(threads=self.io_threads)
            except Exception:
                self._native = False
        if self._native is False:
            self._say_path("in Python (native/segan_io.cpp unavailable)")
            return None
        c_paths, n_paths, begs_c, ends_c, begs_n, ends_n = [], [], [], [], [], []
        uttnames, slice_ids = [], []
        for index in indices:
            w_i, t_i, cb, ce, nb, ne = self.idx2slice[index]
            c_paths.append(self.clean_names[w_i])
            n_paths.append(self.noisy_names[w_i])
            begs_c.append(cb)
            ends_c.append(ce)
            begs_n.append(nb)
            ends_n.append(ne)
            uttnames.append(
                os.path.splitext(os.path.basename(self.noisy_names[w_i]))[0])
            slice_ids.append(t_i)
        try:
            clean = self._native.gather(c_paths, begs_c, ends_c,
                                        self.slice_size, self.preemph)
            noisy = self._native.gather(n_paths, begs_n, ends_n,
                                        self.slice_size, self.preemph)
        except Exception as e:
            print(f"[data] {self.split}: the native gather failed ({e})")
            self._native = False
            self._say_path("in Python (the native gather failed)")
            return None
        self._say_path("by native/segan_io.cpp")
        return {"uttname": uttnames, "clean": clean, "noisy": noisy,
                "slice_idx": np.asarray(slice_ids, np.int32)}

    def __getitem__(self, index: int) -> dict:
        w_i, t_i, cb, ce, nb, ne = self.idx2slice[index]
        c_path = self.clean_names[w_i]
        n_path = self.noisy_names[w_i]
        bname = os.path.splitext(os.path.basename(n_path))[0]
        c_sig = self.read_wav_file(c_path)
        n_sig = self.read_wav_file(n_path)
        c_slice = c_sig[cb:ce]
        n_slice = n_sig[nb:ne]
        L = min(c_slice.shape[0], n_slice.shape[0])
        c_slice, n_slice = c_slice[:L], n_slice[:L]
        if c_slice.shape[0] < self.slice_size:
            pad = np.zeros((self.slice_size - c_slice.shape[0],), np.float32)
            c_slice = np.concatenate((c_slice, pad))
            n_slice = np.concatenate((n_slice, pad))
        pesq = ssnr = None
        met_path = os.path.join(os.path.dirname(n_path), bname + ".met")
        if os.path.exists(met_path):
            with open(met_path, "r") as f:
                met = json.load(f)
            pesq, ssnr = met["pesq"], met["ssnr"]
        rscale = _random.choice(self.random_scale)
        if rscale != 1:
            c_slice = rscale * c_slice
            n_slice = rscale * n_slice
        return {
            "uttname": bname,
            "clean": c_slice.astype(np.float32),
            "noisy": n_slice.astype(np.float32),
            "slice_idx": t_i,
            "pesq": pesq,
            "ssnr": ssnr,
        }

    def __len__(self):
        return len(self.idx2slice)
