"""Training throughput of the port: the counterpart of the repo's ``bench.py``.

    python -m segan_pytorch_tpu_torch.bench [--engine segan|wsegan|aewsegan]
        [--preset full|tiny] [--batch_size 300] [--compute_dtype bfloat16] [--steps 15]
        [--warmup 3] [--steps_per_call 4] [--dp N] [--device cuda|cpu]

Runs one engine's train step (seeded random weights) on one synthetic batch staged on
the device, as ``bench.py`` builds it: clean ~ N(0, 0.1^2), noisy = clean + N(0,
0.02^2), every row valid, l1 weight 100. ``segan`` is SEGAN+'s three-phase step;
``wsegan`` the WSEGAN step with ``bench.py``'s flags (spectral norm in G and D, Adam,
the misaligned pair; no utterance 'additive'); ``aewsegan`` the G-only step with Adam.
Each of ``--steps`` timed calls (and ``--warmup`` untimed ones) runs ``--steps_per_call``
steps, by default 4 as in ``bench.py``: on the card the step's CUDA graph replayed that
many times (``train_step_multi``), 1 the plain ``train_step``. Completion is forced by
reading a loss on the host after the warm-up and after the timed calls. It prints one
JSON line: {"metric": "train_slices_per_sec_per_chip", "value", "unit", "batch",
"compute_dtype", "device", "engine"}, with "steps_per_call" when it is above 1 and
"mfu" (the step's FLOPs, ``step_flops()``, over its time, over the card's dense bf16
peak) when the card's peak is known. It runs on the CUDA card, and raises without one;
``--device cpu`` asks for the CPU.

``--dp N`` runs N processes, one per card (``parallel/mesh.py`` ``spawn_local``; more
than the cards raises), each on its rows of the one global batch of ``--batch_size``;
the step is the global batch's and runs eagerly (``--steps_per_call`` sub-steps each a
step). Process 0 prints the line, its "value" the global slices/s over N, with "dp" and
"aggregate_slices_per_sec".

It times the bare step. The training run around it, with the wav data, the log points,
validation scoring and checkpoints, is ``python -m segan_pytorch_tpu_torch.train``
(``SEGAN.train``); ``chip_smoke.py`` phase 6 times its loop beside this entry.
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

# bench.py's --preset tiny: a small model for a quick run
TINY = dict(slice_size=4096, genc_fmaps=[16, 32, 64], genc_poolings=[4, 4, 4], z_dim=64,
            denc_fmaps=[16, 32, 64], denc_poolings=[4, 4, 4], dpool_slen=64)


# bench.py's flags of each engine
ENGINE_FLAGS = {
    "segan": {},
    "wsegan": dict(wsegan=True, gnorm_type="snorm", dnorm_type="snorm", opt="adam",
                   misalign_pair=True),
    "aewsegan": dict(aewsegan=True, opt="adam"),
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SEGAN+ train-step throughput")
    parser.add_argument("--engine", choices=("segan", "wsegan", "aewsegan"),
                        default="segan")
    parser.add_argument("--preset", choices=("full", "tiny"), default="full")
    parser.add_argument("--batch_size", type=int, default=300)
    parser.add_argument("--compute_dtype", choices=("float32", "bfloat16"),
                        default="bfloat16")
    parser.add_argument("--steps", type=int, default=15)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--steps_per_call", type=int, default=4,
                        help="Train steps per call (one CUDA graph of the step, replayed "
                             "per step); 1 = one train_step per call.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--dp", type=int, default=1,
                        help="Data-parallel processes, one per card, on the global batch.")
    return parser


def _worker(coordinator, num_processes, process_id, argv):
    """One process of a --dp run (``spawn_local``)."""
    from .parallel.mesh import initialize_distributed, shutdown_distributed

    args = build_parser().parse_args(argv)
    device = initialize_distributed(coordinator, num_processes, process_id, args.device)
    _run(args, device)
    shutdown_distributed()


def main(argv=None):
    """Parse `argv` and time the step; returns the printed line (None where it spawned
    the processes of a --dp run, whose process 0 prints it)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.steps < 1:
        raise ValueError("--steps must be at least 1")
    if args.dp > 1:
        from .parallel.mesh import spawn_local

        if args.device == "cuda" and args.dp > torch.cuda.device_count():
            raise SystemExit(f"--dp {args.dp} needs {args.dp} devices, have "
                             f"{torch.cuda.device_count()}")
        spawn_local(_worker, args.dp, args.device, (argv,))
        return None
    return _run(args, args.device)


def _run(args, device) -> dict:
    from .models.segan import SEGAN
    from .models.wsegan import AEWSEGAN, WSEGAN
    from .parallel.mesh import process_index
    from .utils.config import SEGANConfig
    from .utils.profiling import mfu

    arch = TINY if args.preset == "tiny" else {}
    extra = ENGINE_FLAGS[args.engine]
    cfg = SEGANConfig(batch_size=args.batch_size, compute_dtype=args.compute_dtype,
                      no_train_gen=True, dp=args.dp, **arch, **extra)
    cls = {"segan": SEGAN, "wsegan": WSEGAN, "aewsegan": AEWSEGAN}[args.engine]
    segan = cls(cfg, device=device)
    segan.init_train()
    B, T = args.batch_size, cfg.slice_size
    rng = np.random.RandomState(0)
    clean = torch.from_numpy((rng.randn(B, T, 1) * 0.1).astype(np.float32))
    noisy = clean + torch.from_numpy((rng.randn(B, T, 1) * 0.02).astype(np.float32))
    B //= args.dp  # this process's rows of the global batch
    rows = segan.grid.rows(B) if segan.grid is not None else slice(None)
    clean, noisy = clean[rows].to(segan.device), noisy[rows].to(segan.device)
    mask = torch.ones((B,), device=segan.device)

    S = max(1, args.steps_per_call)
    fetch = "loss" if args.engine == "aewsegan" else "d_real"
    fields = [clean, noisy, mask]
    if args.engine == "wsegan":
        fields.append(torch.zeros((B,), device=segan.device))  # no 'additive' utterance
    if S > 1:
        stacked = [f.expand((S,) + f.shape) for f in fields]

        def one_call():
            return segan.train_step_multi(*stacked, l1_w_s=[100.0] * S)[1][fetch]
    else:
        def one_call():
            return segan.train_step(*fields, 100.0)[0][fetch]

    loss = None
    for _ in range(args.warmup):
        loss = one_call()
    if loss is not None:
        float(loss)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = one_call()
    float(loss)  # waits for the whole chain of steps
    dt = time.perf_counter() - t0
    total = args.steps * S * args.batch_size / dt  # slices/s of the global batch
    result = {"metric": "train_slices_per_sec_per_chip",
              "value": round(total / args.dp, 2), "unit": "slices/s/chip",
              "batch": args.batch_size, "compute_dtype": args.compute_dtype,
              "device": str(segan.device), "engine": args.engine}
    if S > 1:
        result["steps_per_call"] = S
    if args.dp > 1:
        result["dp"] = args.dp
        result["aggregate_slices_per_sec"] = round(total, 2)
    step_mfu = mfu(segan.step_flops(), dt / (args.steps * S))
    if step_mfu is not None:
        result["mfu"] = round(step_mfu, 4)
    if process_index() == 0:
        print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
