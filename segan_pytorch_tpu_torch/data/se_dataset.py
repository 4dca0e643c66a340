"""The paired clean/noisy slice datasets: ``collate_batch``, ``SEDataset`` and
``SEH5Dataset`` of ``segan_pytorch_tpu/data/se_dataset.py``, copied so that the same
corpus, cache and draws give the same slices (``tests/test_torch_data.py`` and
``tests/test_torch_data_options.py`` hold every batch against the JAX one).

``SEDataset`` slices every pair of wavs at a fractional stride and keeps the slice index
in ``{cache_dir}/{split}_idx2slice.json``; an index that is there is read, not rebuilt.
A batch is gathered by the C++ engine (``data/native.py``) when it can be, else item by
item in Python: both give the same bytes. With a ``transform`` (``data/augment.py``
``Additive``, ``--noises_dir``) the noisy slice is made anew from the clean one at every
read. ``SEH5Dataset`` reads the pre-cut slices of ``{split}.h5`` (``tools/make_h5.py``
writes them). ``RandomChunkSEDataset`` draws one random slice of each pair per read,
and ``RandomChunkSEF0Dataset`` one of each clean wav with its F0 frames
(``tests/test_torch_aux_data.py`` holds both against the JAX ones).
"""
from __future__ import annotations

import glob
import json
import multiprocessing as mp
import os
import random as _random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.signal import (abs_normalize_wave_minmax, normalize_wave_minmax,
                          pre_emphasize_np, slice_signal_indices)
from .aco import interpolation, read_aco_file
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
        transform=None,
        io_threads: int = 0,
    ):
        """transform: an augmenter called as transform(clean slice) -> noisy slice on
        the normalized clean signal, before pre-emphasis (``data/augment.py``
        ``Additive``); with one the noisy slice is made from the clean one at every read
        and both are pre-emphasized after, and the item's name gets an '_additive'
        suffix, which switches on WSEGAN's additive L1 term (upstream's
        model.py:657-665). It cannot go with preemph_norm, which pre-emphasizes before
        normalizing."""
        if transform is not None and preemph_norm:
            raise ValueError(
                "transform (additive augmentation) operates on the normalized "
                "pre-pre-emphasis signal; preemph_norm inverts that order and is "
                "not supported together")
        self.transform = transform
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
        return self._remember(path, wav.astype(np.float32))

    def read_wav_file_norm(self, path: str) -> np.ndarray:
        """The normalized signal without pre-emphasis: what the transform works on."""
        key = path + "#norm"
        if key in self._wav_cache:
            return self._wav_cache[key]
        rate, wav = read_wav_raw(path)
        return self._remember(
            key, np.asarray(normalize_wave_minmax(np.asarray(wav))).astype(np.float32))

    def _remember(self, key: str, wav: np.ndarray) -> np.ndarray:
        """Keep `wav` in a small cache so that a file is not re-read for every slice
        (loader workers share this dict: tolerate concurrent evictions)."""
        if len(self._wav_cache) > 64:
            try:
                self._wav_cache.pop(next(iter(self._wav_cache)))
            except (KeyError, StopIteration, RuntimeError):
                pass
        self._wav_cache[key] = wav
        return wav

    def _say_path(self, how: str):
        if not self._path_said:
            self._path_said = True
            print(f"[data] {self.split}: batches gathered {how}")

    # ------------------------------------------------------------------
    def gather_batch(self, indices) -> Optional[dict]:
        """The C++ path: decode, normalize, pre-emphasize and slice a whole batch in a
        thread pool. Returns None when it does not apply (pre-emphasis first, .met
        sidecars, random scaling, a transform) or the library is unavailable: callers
        then take the Python path."""
        if self.preemph_norm or self.random_scale != [1] or self.transform is not None:
            self._say_path("in Python (preemph_norm, random_scale or a transform)")
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
        if self.transform is not None:
            # noisy is made anew from the normalized clean slice at a drawn SNR, then
            # both sides are pre-emphasized
            c_raw = self.read_wav_file_norm(c_path)[cb:ce]
            n_raw = self.transform(c_raw)
            c_slice = pre_emphasize_np(c_raw, self.preemph)
            n_slice = pre_emphasize_np(np.asarray(n_raw, np.float32), self.preemph)
            bname = bname + "_additive"
        else:
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


class SEH5Dataset:
    """Pre-cut slice pairs of ``{data_root}/{split}.h5``: clean under 'data', noisy under
    'label', each (n, slice) or (n, slice, 1) (upstream's se_dataset.py:527-568). Items
    are named 'N/A'; ``random_scale`` scales both sides as ``SEDataset`` does.
    ``preemph`` and ``preemph_norm`` are taken for the signature's sake: the file holds
    pre-emphasized slices. Needs ``h5py``."""

    def __init__(
        self,
        data_root: str,
        split: str,
        preemph: float,
        verbose: bool = False,
        preemph_norm: bool = False,
        random_scale: Sequence[float] = (1,),
    ):
        try:
            import h5py
        except ImportError as e:
            raise ImportError("the H5 dataset (--h5) needs the h5py package, which is "
                              "not installed") from e

        h5_file = os.path.join(data_root, split + ".h5")
        if not os.path.exists(h5_file):
            raise FileNotFoundError(h5_file)
        self.f = h5py.File(h5_file, "r")
        ks = list(self.f.keys())
        assert "data" in ks, ks
        assert "label" in ks, ks
        if verbose:
            print(f"Found H5 file {h5_file} with {self.f['data'].shape[0]} samples")
        self.random_scale = list(random_scale)

    def __getitem__(self, index: int) -> dict:
        c = np.asarray(self.f["data"][index], np.float32)
        n = np.asarray(self.f["label"][index], np.float32)
        if c.ndim > 1:
            c = np.squeeze(c, axis=-1)
        if n.ndim > 1:
            n = np.squeeze(n, axis=-1)
        rscale = _random.choice(self.random_scale)
        if rscale != 1:
            c, n = rscale * c, rscale * n
        return {"uttname": "N/A", "clean": c, "noisy": n, "slice_idx": 0,
                "pesq": None, "ssnr": None}

    def __len__(self):
        return self.f["data"].shape[0]


class RandomChunkSEDataset:
    """One random slice per utterance per read (upstream's se_dataset.py:373-448): the
    pair read at 16 kHz in [-1, 1], pre-emphasized, cut at a start drawn from the
    module-level ``random`` (so a seeded ``random.seed`` gives the JAX package's slices),
    and a pair shorter than the slice zero-padded at its end. With ``utt2spk`` (a file of
    'utterance<TAB>speaker' lines) and ``spk2idx`` each item has 'spkid'.
    ``split`` and ``max_samples`` are taken for the signature's sake."""

    def __init__(
        self,
        clean_dir: str,
        noisy_dir: str,
        preemph: float,
        split: str = "train",
        slice_size: int = 2**14,
        max_samples: Optional[int] = None,
        utt2spk: Optional[str] = None,
        spk2idx: Optional[dict] = None,
    ):
        self.preemph = preemph
        self.slice_size = slice_size
        self.utt2spk = utt2spk
        self.spk2idx = spk2idx
        if self.utt2spk is not None and self.spk2idx is None:
            raise ValueError("Please specify spk2idx too with utt2spk!")
        if utt2spk is not None:
            self._read_utt2spk()
        self.samples = {}
        self.clean_names = sorted(glob.glob(os.path.join(clean_dir, "*.wav")))
        for c_i, cname in enumerate(self.clean_names):
            bname = os.path.basename(cname)
            self.samples[c_i] = {
                "clean": cname,
                "noisy": os.path.join(noisy_dir, bname),
            }

    def _read_utt2spk(self):
        utt2spk = {}
        with open(self.utt2spk, "r") as f:
            for line in f:
                parts = line.rstrip().split("\t")
                uttname = os.path.splitext(os.path.basename(parts[0]))[0]
                utt2spk[uttname] = parts[1]
        self.utt2spk = utt2spk

    def read_wav_file(self, path: str) -> np.ndarray:
        wav, _ = read_wav_16k(path, 16000)
        return pre_emphasize_np(wav, self.preemph)

    def __getitem__(self, index: int) -> dict:
        sample = self.samples[index]
        bname = os.path.splitext(os.path.basename(sample["clean"]))[0]
        cwav = self.read_wav_file(sample["clean"])
        nwav = self.read_wav_file(sample["noisy"])
        min_L = min(cwav.shape[0], nwav.shape[0])
        slice_size = min(self.slice_size, min_L)
        beg = _random.randint(0, min_L - slice_size)
        cslice = cwav[beg : beg + self.slice_size]
        nslice = nwav[beg : beg + self.slice_size]
        if min_L < self.slice_size:
            cslice = np.concatenate(
                (cslice, np.zeros(self.slice_size - cslice.shape[0], np.float32))
            )
            nslice = np.concatenate(
                (nslice, np.zeros(self.slice_size - nslice.shape[0], np.float32))
            )
        out = {
            "uttname": bname,
            "clean": cslice.astype(np.float32),
            "noisy": nslice.astype(np.float32),
            "slice_idx": 0,
            "pesq": None,
            "ssnr": None,
        }
        if isinstance(self.utt2spk, dict):
            out["spkid"] = self.spk2idx[self.utt2spk[bname]]
        return out

    def __len__(self):
        return len(self.samples)


class RandomChunkSEF0Dataset:
    """Random slices of the clean wavs paired with their F0 targets (upstream's
    se_dataset.py:450-525): '{noisy_dir}/{name}.lf0' (``data/aco.py`` format) with its
    unvoiced frames interpolated (log 60 where none is voiced) and an end-of-sequence
    zero frame, cut to the slice's 80-sample frames plus one. The wav is pre-emphasized,
    then scaled by its largest magnitude as int32 (``abs_normalize_wave_minmax``); the
    start is drawn from the module-level ``random``."""

    def __init__(self, clean_dir: str, noisy_dir: str, preemph: float = 0,
                 split: str = "train", slice_size: int = 2**14,
                 max_samples: Optional[int] = None):
        self.preemph = preemph
        self.slice_size = slice_size
        self.samples = {}
        self.clean_names = sorted(glob.glob(os.path.join(clean_dir, "*.wav")))
        for c_i, cname in enumerate(self.clean_names):
            bname = os.path.splitext(os.path.basename(cname))[0]
            self.samples[c_i] = {
                "clean": cname,
                "noisy": os.path.join(noisy_dir, bname) + ".lf0",
            }

    def read_wav_file(self, path: str) -> np.ndarray:
        rate, wav = read_wav_raw(path)
        wav = pre_emphasize_np(np.asarray(wav, np.float32), self.preemph)
        return np.asarray(abs_normalize_wave_minmax(wav), np.float32)

    def __getitem__(self, index: int) -> dict:
        sample = self.samples[index]
        bname = os.path.splitext(os.path.basename(sample["clean"]))[0]
        cwav = self.read_wav_file(sample["clean"])
        lf0 = read_aco_file(sample["noisy"])
        ilf0, uv = interpolation(lf0, -10000000000)
        ilf0 = np.where(ilf0 < -1000, np.log(60), ilf0)
        ilf0 = np.concatenate((ilf0, np.zeros((1,), np.float32)))  # the EOS frame
        uv = np.concatenate((uv, np.zeros((1,), np.float32)))
        min_L = cwav.shape[0]
        slice_size = min(self.slice_size, min_L)
        beg = _random.randint(0, min_L - slice_size)
        cslice = cwav[beg : beg + self.slice_size]
        lf0slice = np.zeros(((self.slice_size // 80) + 1,), np.float32)
        uvslice = np.zeros(((self.slice_size // 80) + 1,), np.float32)
        ilf0_s = ilf0[beg // 80 : beg // 80 + (self.slice_size // 80) + 1]
        uv_s = uv[beg // 80 : beg // 80 + (self.slice_size // 80) + 1]
        lf0slice[: ilf0_s.shape[0]] = ilf0_s
        uvslice[: uv_s.shape[0]] = uv_s
        if min_L < self.slice_size:
            cslice = np.concatenate(
                (cslice, np.zeros((self.slice_size - cslice.shape[0],), np.float32)))
        return {"uttname": bname, "clean": cslice.astype(np.float32),
                "lf0": lf0slice, "uv": uvslice, "slice_idx": 0,
                "pesq": None, "ssnr": None}

    def __len__(self):
        return len(self.samples)
