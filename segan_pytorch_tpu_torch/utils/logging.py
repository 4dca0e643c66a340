"""Training observability: the counterpart of ``segan_pytorch_tpu/utils/logging.py``
(``TrainLogger``) and of ``StepTimer`` in ``segan_pytorch_tpu/utils/profiling.py``.

Scalars go to ``<logdir>/scalars.jsonl`` and, when tensorboardX is importable, to
TensorBoard with the histograms. Histograms take tensors and read them on the host only
when TensorBoard is on, so without it they cost no device sync.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


class StepTimer:
    """btime / mbtime running stats of the loop's log line."""

    def __init__(self, window: int = 200):
        self.times = []
        self.window = window
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def last(self) -> float:
        return self.times[-1] if self.times else 0.0

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0


class TrainLogger:
    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            self.tb = SummaryWriter(logdir)
        except Exception:
            self.tb = None
        self.jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int):
        if self.tb is not None:
            self.tb.add_scalar(tag, float(value), step)
        self.jsonl.write(json.dumps({"t": time.time(), "tag": tag,
                                     "value": float(value), "step": int(step)}) + "\n")
        self.jsonl.flush()

    def histogram(self, tag: str, values, step: int):
        if self.tb is None:
            return
        if torch.is_tensor(values):
            values = values.detach().float().cpu().numpy()
        self.tb.add_histogram(tag, np.asarray(values), step, bins="sturges")

    def weight_norms(self, module: torch.nn.Module, total_name: str, step: int):
        """Per-layer and total weight norms. Every norm is computed on the device
        (``torch._foreach_norm``) and the scalars come to the host in one transfer: the
        parameters never leave the device."""
        named = [(n, p) for n, p in module.named_parameters() if n.endswith("weight")]
        if not named:
            return
        norms = torch.stack(torch._foreach_norm(
            [p.detach().float() for _, p in named])).tolist()
        for (name, _), wn in zip(named, norms):
            self.scalar(f"{name}_Wnorm", wn, step)
        self.scalar(f"{total_name}_Wnorm", float(sum(norms)), step)

    def close(self):
        if self.tb is not None:
            self.tb.close()
        self.jsonl.close()
