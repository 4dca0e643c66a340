"""A/B of the chained enc2 + enc3 kernel on one CUDA device: the port of
``tools/encoder_fused_bench.py``.

    python -m segan_pytorch_tpu_torch.tools.encoder_fused_bench [--batch 300]
        [--dtype bfloat16|float32]

At the SEGAN+ enc2 + enc3 shapes (h1 (B, 64, 4096) -> 128 -> 256 channels, batch 300 by
default, the training batch) it times three arms, each returning (pre2, pre3, post3):

  plain chain : reflect pad -> conv + bias + PReLU twice in plain PyTorch (cuDNN, TF32 off)
  kernel x2   : reflect pad -> the per-layer kernel (``fused_conv1d_prelu``) twice
  fused 2+3   : the chained kernel (``fused_enc23_fwd``), post2 kept on chip

and prints each arm's time (CUDA events, median of 20 after 3 warm-ups), the route and
tile the chained kernel took (read from its launch counters: in fp32 the 3xTF32 tensor
cores at every SEGAN+ shape, in bf16 ``mma.sync``) and the max |plain - fused| of each
output beside its relative error. The data is the JAX tool's:
``np.random.RandomState(0)`` in the same order and scales. The JAX tool's ``--bt`` (the
Pallas kernel's VMEM batch tile) has no counterpart. The CLI needs a CUDA device; the
arm functions take tensors on any device.
"""
from __future__ import annotations

import argparse
import statistics
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.conv import reflect_pad_1d
from ..ops.kernels import encoder_fused as EF
from ..ops.kernels.conv1d_prelu import fused_conv1d_prelu

C1, C2, C3 = 64, 128, 256
T1 = 4096  # enc1's output length for one 16384-sample chunk


def make_inputs(batch: int, t1: int = T1, dtype: torch.dtype = torch.bfloat16,
                device="cpu") -> Tuple[torch.Tensor, ...]:
    """(h1, w2, b2, a2, w3, b3, a3) as the JAX tool draws them (JAX layout, float32,
    then cast), moved to the port's layout: h1 (B, C1, T1), w (Cout, Cin, K)."""
    rng = np.random.RandomState(0)
    h1 = rng.randn(batch, t1, C1).astype(np.float32) * 0.1
    w2 = rng.randn(EF.K, C1, C2).astype(np.float32) * 0.05
    b2 = rng.randn(C2).astype(np.float32) * 0.05
    a2 = rng.randn(C2).astype(np.float32) * 0.05
    w3 = rng.randn(EF.K, C2, C3).astype(np.float32) * 0.05
    b3 = rng.randn(C3).astype(np.float32) * 0.05
    a3 = rng.randn(C3).astype(np.float32) * 0.05
    port = (h1.transpose(0, 2, 1), w2.transpose(2, 1, 0), b2, a2, w3.transpose(2, 1, 0),
            b3, a3)
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=dtype)
                 for v in port)


def kernel_x2(h1, w2, b2, a2, w3, b3, a3):
    """The per-layer kernel twice, post2 through device memory."""
    post2, pre2 = fused_conv1d_prelu(reflect_pad_1d(h1, *EF.PAD), w2, b2, a2, EF.S)
    post3, pre3 = fused_conv1d_prelu(reflect_pad_1d(post2, *EF.PAD), w3, b3, a3, EF.S)
    return pre2, pre3, post3


ARMS: Dict[str, Callable] = {
    "plain chain": EF.enc23_plain,
    "kernel x2": kernel_x2,
    "fused 2+3": EF.fused_enc23_fwd,
}


def cuda_ms(fn: Callable, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one pair of CUDA events per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ms_in_turns(arms: Dict[str, Callable], reps: int = 20, warmup: int = 3
                ) -> Dict[str, float]:
    """Median device time in ms of each of `arms` (name -> fn), timed in turns: one call
    of each per round, a pair of CUDA events per call, synchronised after each, after
    `warmup` rounds. Versions compared so share the card's state (clocks, heat, L2)."""
    times: Dict[str, list] = {name: [] for name in arms}
    for i in range(warmup + reps):
        for name, fn in arms.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i >= warmup:
                times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def route_taken(run: Callable, dtype: torch.dtype) -> Tuple[str, int]:
    """(route, tile) that the chained kernel took in run(), read from its counters:
    "tf32" (3xTF32), "mma" (bf16) or "fma", and its enc3 rows per block."""
    before = (EF.launches, EF.launches_tf32, EF.launches_tile16)
    run()
    launched, tf32, tile16 = (n - b for n, b in zip(
        (EF.launches, EF.launches_tf32, EF.launches_tile16), before))
    if launched != 1:
        raise RuntimeError(f"the chained kernel launched {launched} times, not once")
    if tf32:
        return "tf32", 16 if tile16 else 32
    return ("mma" if dtype == torch.bfloat16 else "fma"), 32


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the A/B; returns {"ms": {arm: ms}, "max_abs": {...}, "rel": {...}, "route":
    ..., "tile": ...}, the errors of 'fused 2+3' against 'plain chain' by output and the
    chained kernel's route and tile."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=300)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("encoder_fused_bench needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    inputs = make_inputs(args.batch, dtype=dtype, device="cuda")
    print(f"enc2+enc3, h1 {tuple(inputs[0].shape)} {args.dtype} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    res = {"ms": {}, "max_abs": {}, "rel": {}}
    outs = {}
    for name, arm in ARMS.items():
        outs[name] = arm(*inputs)
        res["ms"][name] = cuda_ms(lambda: arm(*inputs))
        print(f"{name:<12}: {res['ms'][name]:8.3f} ms", flush=True)
    res["route"], res["tile"] = route_taken(lambda: EF.fused_enc23_fwd(*inputs), dtype)
    print(f"fused 2+3 took the {res['route']} route, {res['tile']} enc3 rows per block")
    for i, name in enumerate(("pre2", "pre3", "post3")):
        ref = outs["plain chain"][i].float()
        diff = float((outs["fused 2+3"][i].float() - ref).abs().max())
        res["max_abs"][name] = diff
        res["rel"][name] = diff / max(float(ref.abs().max()), 1e-30)
        print(f"  max|plain - fused| {name}: {diff:.3e} (relative {res['rel'][name]:.3e})")
    return res


if __name__ == "__main__":
    main()
