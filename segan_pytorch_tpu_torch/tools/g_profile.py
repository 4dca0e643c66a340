"""Where the device time of a full-width SEGAN+ generator forward, or of a train step,
goes on one CUDA device.

    python -m segan_pytorch_tpu_torch.tools.g_profile [--batch 64] [--dtype bfloat16]
        [--forwards 5] [--train] [--wsegan]

G (and with ``--train`` D) is built at the SEGAN+ widths from a seed, with PReLU slopes
drawn in U(0, 0.3) (a fresh model has them at 0), and runs ``SEGAN.infer_G`` (with
``--train``: ``SEGAN.train_step``, l1 weight 100) on a batch of 16384-sample chunks.
``--wsegan`` takes the WSEGAN engine with ``scripts/run_wsegan_train.sh``'s flags
(spectral norm in G and D, Adam, the misaligned pair, biases) instead of SEGAN+'s
(``--no_bias``).
After two warm-up calls, ``torch.profiler`` records ``--forwards`` calls; the kernels'
device time is summed by class (the port's fused conv + PReLU kernels, cuDNN's
convolutions (in G's forward: the decoder's transposed convs), the reflect pads,
the concatenations, the reductions, the optimizer steps, the rest) and set against the
wall time of a call (CUDA events, median of 10), which gives the device's idle share.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.discriminator import build_discriminator
from ..models.generator import build_generator
from ..models.segan import SEGAN
from ..utils.config import SEGANConfig
from .encoder_fused_bench import cuda_ms

CLASSES = [  # (class, substrings of a kernel's name), the first match wins
    ("fused conv + PReLU (port kernels)", ("conv1d_mma_kernel", "conv1d_tf32_kernel",
                                           "conv1d_wgmma_kernel", "conv1d_wgmma_tf32_kernel",
                                           "conv1d_prelu_kernel", "splitk_epilogue_kernel")),
    ("cuDNN convolutions", ("conv", "gemm", "xmma", "dgrad", "cudnn")),
    ("reflect pads", ("reflection_pad", "reflect")),
    ("concatenations", ("cat",)),
    ("reductions (BatchNorm statistics, bias and slope gradients, losses)", ("reduce",)),
    ("FFTs (WSEGAN's STFT power loss)", ("fft",)),
    ("matrix-vector products (spectral norm's power iteration and sigma)", ("gemv", "dot")),
    ("optimizer steps", ("multi_tensor", "foreach")),
]


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise and other"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Profile; returns {"wall_ms": ms per call, "busy_ms": device ms per call,
    "classes": {class: device ms per call}, "kernels": {name: device ms per call}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--forwards", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step (G and D) instead of G's forward")
    ap.add_argument("--wsegan", action="store_true",
                    help="the WSEGAN engine with scripts/run_wsegan_train.sh's flags")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("g_profile needs a CUDA device")
    if args.wsegan:
        from ..models.wsegan import WSEGAN as engine_cls

        cfg = SEGANConfig(compute_dtype=args.dtype, wsegan=True, gnorm_type="snorm",
                          dnorm_type="snorm", opt="adam", misalign_pair=True)
    else:
        engine_cls = SEGAN
        cfg = SEGANConfig(no_bias=True, compute_dtype=args.dtype)
    gen = torch.Generator().manual_seed(args.seed)
    G = build_generator(cfg, gen)
    D = build_discriminator(cfg, gen) if args.train else None
    with torch.no_grad():
        for model in (G, D) if args.train else (G,):
            for name, p in model.named_parameters():
                if name.endswith("act.weight"):
                    p.uniform_(0.0, 0.3, generator=gen)
    engine = engine_cls(cfg, generator=G, discriminator=D, device="cuda")
    x = torch.from_numpy(np.random.RandomState(args.seed).randn(
        args.batch, cfg.slice_size, 1).astype(np.float32) * 0.3).cuda()
    z = G.sample_z(tuple(x.shape), gen).cuda()
    if args.train and args.wsegan:
        what = "WSEGAN train step"
        run = lambda: engine.train_step(x, x, None, None, 100.0, z=z)  # noqa: E731
    elif args.train:
        what = "train step"
        run = lambda: engine.train_step(x, x, None, 100.0, z=z)  # noqa: E731
    else:
        what = "G forward"
        run = lambda: engine.infer_G(x, z)  # noqa: E731
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.forwards):
            run()
        torch.cuda.synchronize()
    kernels: Dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time_total / 1e3
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    kernels = {k: v / args.forwards for k, v in kernels.items()}
    busy = sum(kernels.values())
    wall = cuda_ms(run, reps=10, warmup=2)
    classes: Dict[str, float] = {}
    for name, ms in kernels.items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + ms
    print(f"{what}, batch {args.batch} {args.dtype}, on {torch.cuda.get_device_name(0)}: "
          f"{wall:.3f} ms wall (CUDA events, median), device busy {busy:.3f} ms "
          f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}")
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms {ms / busy:6.1%}  {cls}")
    print("  top kernels:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.3f} ms {ms / busy:6.1%}  {name[:100]}")
    return {"wall_ms": wall, "busy_ms": busy, "classes": classes, "kernels": kernels}


if __name__ == "__main__":
    main()
