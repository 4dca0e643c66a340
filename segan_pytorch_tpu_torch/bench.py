"""Training throughput of the port: the counterpart of the repo's ``bench.py`` for
``--engine segan``.

    python -m segan_pytorch_tpu_torch.bench [--preset full|tiny] [--batch_size 300]
        [--compute_dtype bfloat16] [--steps 15] [--warmup 3] [--device cuda|cpu]

Runs SEGAN+'s three-phase train step (``SEGAN.train_step``, seeded random weights) on
one synthetic batch staged on the device, as ``bench.py`` builds it: clean ~ N(0, 0.1^2),
noisy = clean + N(0, 0.02^2), every row valid, l1 weight 100. Completion is forced by
reading a loss on the host after the warm-up and after the timed steps. It prints one
JSON line: {"metric": "train_slices_per_sec_per_chip", "value", "unit", "batch",
"compute_dtype", "device"}. It runs on the CUDA card, and raises without one;
``--device cpu`` asks for the CPU.

It times the bare step. The training run around it, with the wav data, the log points,
validation scoring and checkpoints, is ``python -m segan_pytorch_tpu_torch.train``
(``SEGAN.train``); ``chip_smoke.py`` phase 6 times its loop beside this entry.
"""
import argparse
import json
import time

import numpy as np
import torch

# bench.py's --preset tiny: a small model for a quick run
TINY = dict(slice_size=4096, genc_fmaps=[16, 32, 64], genc_poolings=[4, 4, 4], z_dim=64,
            denc_fmaps=[16, 32, 64], denc_poolings=[4, 4, 4], dpool_slen=64)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SEGAN+ train-step throughput")
    parser.add_argument("--preset", choices=("full", "tiny"), default="full")
    parser.add_argument("--batch_size", type=int, default=300)
    parser.add_argument("--compute_dtype", choices=("float32", "bfloat16"),
                        default="bfloat16")
    parser.add_argument("--steps", type=int, default=15)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from .models.segan import SEGAN
    from .utils.config import SEGANConfig

    if args.steps < 1:
        raise ValueError("--steps must be at least 1")
    arch = TINY if args.preset == "tiny" else {}
    cfg = SEGANConfig(batch_size=args.batch_size, compute_dtype=args.compute_dtype,
                      no_train_gen=True, **arch)
    segan = SEGAN(cfg, device=args.device)
    B, T = args.batch_size, cfg.slice_size
    rng = np.random.RandomState(0)
    clean = torch.from_numpy((rng.randn(B, T, 1) * 0.1).astype(np.float32))
    noisy = clean + torch.from_numpy((rng.randn(B, T, 1) * 0.02).astype(np.float32))
    clean, noisy = clean.to(segan.device), noisy.to(segan.device)
    mask = torch.ones((B,), device=segan.device)

    metrics = None
    for _ in range(args.warmup):
        metrics, _, _ = segan.train_step(clean, noisy, mask, 100.0)
    if metrics is not None:
        float(metrics["d_real"])
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics, _, _ = segan.train_step(clean, noisy, mask, 100.0)
    float(metrics["d_real"])  # waits for the whole chain of steps
    dt = time.perf_counter() - t0
    result = {"metric": "train_slices_per_sec_per_chip",
              "value": round(args.steps * B / dt, 2), "unit": "slices/s/chip",
              "batch": B, "compute_dtype": args.compute_dtype,
              "device": str(segan.device)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
