"""The one-to-one voice-conversion dataset: a copy of
``segan_pytorch_tpu/data/vc_dataset.py`` (numpy and scipy only), pinned to it by
``tests/test_torch_aux_data.py``."""
from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from ..ops.signal import normalize_wave_minmax, pre_emphasize_np
from .wav_io import read_wav_raw


def varlen_wav_collate(batch):
    """Zero-pad every source and every target to the longest of the batch: ("", src (B,
    S), trg (B, T)), float32. A sample is (src, trg) or (name, src, trg)."""
    srcs = []
    trgs = []
    for sample in batch:
        if len(sample) == 3:
            _, src, trg = sample
        else:
            src, trg = sample
        srcs.append(np.asarray(src, np.float32))
        trgs.append(np.asarray(trg, np.float32))
    src_max = max(s.shape[0] for s in srcs)
    trg_max = max(t.shape[0] for t in trgs)
    src_b = np.zeros((len(batch), src_max), np.float32)
    trg_b = np.zeros((len(batch), trg_max), np.float32)
    for i, (s, t) in enumerate(zip(srcs, trgs)):
        src_b[i, : s.shape[0]] = s
        trg_b[i, : t.shape[0]] = t
    return "", src_b, trg_b


class VCDataset:
    """Pairs each source wav with the target wav of the same name: (src, trg), each
    normalised to [-1, 1] and pre-emphasized by ``preemph``."""

    def __init__(self, src_path: str, trg_path: str, preemph: float = 0):
        self.preemph = preemph
        self.src_files: List[str] = sorted(glob.glob(os.path.join(src_path, "*.wav")))
        self.trg_files: List[str] = []
        for src_file in self.src_files:
            bname = os.path.basename(src_file)
            trg_file = os.path.join(trg_path, bname)
            if not os.path.exists(trg_file):
                raise FileNotFoundError(trg_file)
            self.trg_files.append(trg_file)

    def read_wav_file(self, path: str):
        rate, wav = read_wav_raw(path)
        wav = np.asarray(normalize_wave_minmax(np.asarray(wav)))
        return rate, pre_emphasize_np(wav, self.preemph)

    def __getitem__(self, index: int):
        src = self.read_wav_file(self.src_files[index])[1]
        trg = self.read_wav_file(self.trg_files[index])[1]
        return src, trg

    def __len__(self):
        return len(self.src_files)
