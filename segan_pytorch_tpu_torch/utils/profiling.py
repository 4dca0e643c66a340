"""Tracing and profiling: the counterpart of ``segan_pytorch_tpu/utils/profiling.py``.
The step timer of the loop's log line is ``utils/logging.py`` ``StepTimer``.

- ``device_trace(logdir)``: a ``torch.profiler`` trace of the host and, on a card, of the
  device, written as a Chrome / Perfetto trace (``trace_<pid>.json``) under ``logdir``.
- ``annotate(name)``: a named range in that trace.
- ``peak_flops_per_chip()``, ``mfu(...)``: model FLOPs utilisation against the card's
  dense bf16 peak, whatever the step's dtype, as the JAX package defines it.
- ``count_flops(fn)``: the FLOPs of the convolutions and matmuls ``fn`` runs
  (``torch.utils.flop_counter``), on any device, fake tensors included.
- ``device_memory_stats()``: the caching allocator's bytes per card.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block (CPU, and CUDA when a card is there) and write its trace as
    ``logdir/trace_<pid>.json``, which chrome://tracing and Perfetto read."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """A named range that shows in ``device_trace``'s trace."""
    return torch.profiler.record_function(name)


# Dense (no sparsity) bf16 tensor-core peak FLOP/s per card, by torch.cuda.get_device_name.
# Source: NVIDIA's H100 data sheet, SXM part: 989 TFLOP/s bf16 at its 700 W limit. The
# CPU and unknown cards are absent: MFU is only reported on a card of this table.
_PEAK_FLOPS_BY_NAME = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops_per_chip() -> Optional[float]:
    """The current card's dense bf16 peak FLOP/s, or None (no card, or one not in the
    table)."""
    if not torch.cuda.is_available():
        return None
    return _PEAK_FLOPS_BY_NAME.get(torch.cuda.get_device_name())


def mfu(flops_per_step: Optional[float], step_seconds: float,
        n_chips: int = 1) -> Optional[float]:
    """Model FLOPs utilisation in [0, 1]: the step's FLOPs over its seconds, over the
    peak of ``n_chips`` cards; None when either is unknown."""
    peak = peak_flops_per_chip()
    if not flops_per_step or not peak or step_seconds <= 0:
        return None
    return flops_per_step / step_seconds / (peak * max(n_chips, 1))


def count_flops(fn: Callable[[], object]) -> int:
    """The FLOPs of the convolutions, transposed convolutions and matmuls that ``fn()``
    dispatches, forward and backward (``torch.utils.flop_counter.FlopCounterMode``)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def device_memory_stats() -> dict:
    """Per card, the caching allocator's bytes in use, their peak and the card's size,
    under the JAX package's keys; {} without a card."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
                            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
                            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return out
