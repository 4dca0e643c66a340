"""Product-path train throughput of the port: the counterpart of the repo's
``tools/train_throughput_bench.py``. End-to-end slices/s of the real training loop
(``python -u -m segan_pytorch_tpu_torch.train``) at the canonical batch-300 SEGAN+
config.

``bench`` stages device-resident inputs, so its number isolates the step. This tool
measures what a user of the shipped CLI gets: the native gather loader -> host batch
assembly -> the copy to the card -> the step (a CUDA graph of ``--steps_per_call``
steps) -> the logging reads -> the EOE checkpoint saves, by timestamping the loop's own
``(Iter i) Batch b/n (Epoch e)`` lines and dividing slices by wall time across a
steady-state window (the first ``--skip_epochs`` epochs, which build the kernels' plans,
cuDNN's and the graph, are left out).

    python -m segan_pytorch_tpu_torch.tools.make_demo_corpus --out corpus --n_train 1000
    python -m segan_pytorch_tpu_torch.tools.train_throughput_bench --corpus corpus \\
        --batch_size 300 --epoch 14 [--loader_dtype bfloat16] [--device cpu]

It prints one JSON line with the JAX tool's keys. The trainer runs on the CUDA card
unless ``--device cpu`` is given (without a card it fails, and the tool with it).
``device_only_slices_per_sec`` is null: the JAX tool reads it from the repo's
``BENCH_r*.json`` files, TPU measurements that say nothing of the port, which has no such
file yet.

The flags it passes mean in the port what they mean in the JAX trainer:
``--compute_dtype bfloat16``, ``--no_bias`` and ``--no_train_gen`` as named;
``--steps_per_call S`` runs S steps per call (in the port one CUDA graph of the step,
replayed S times); ``--io_threads N`` sizes the native wav gather's thread pool (0 = one
per hardware thread, in both trainers); ``--eoe_save_every N`` saves the EOE checkpoints
every N epochs and at the last (the port's saves copy to the host and write on a
thread, as the JAX trainer's async savers do); ``--slice_workers 2`` builds the slice
index with a pool of two processes (the port's is spawned); ``--loader_dtype bfloat16``
casts the batches at collate time, so 2 bytes a sample cross to the card.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

LOG_RE = re.compile(r"\(Iter (\d+)\) Batch (\d+)/(\d+) \(Epoch (\d+)\)")
# the directory that holds the package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def steady_state(marks, skip_epochs: int, batch_size: int):
    """slices/s over the (wall, iteration, epoch) marks with epoch <= skip_epochs
    excluded (they build the plans and the graph). Returns (slices_per_sec, steps,
    wall_s); raises if the window is degenerate."""
    window = [m for m in marks if m[2] > skip_epochs]
    if len(window) < 2:
        raise ValueError(f"not enough log marks ({len(marks)}, "
                         f"{len(window)} past epoch {skip_epochs}) for a "
                         "steady-state window; lower --skip_epochs")
    (t_a, it_a, _), (t_b, it_b, _) = window[0], window[-1]
    steps = it_b - it_a
    if steps <= 0 or t_b <= t_a:
        raise ValueError("degenerate steady-state window")
    return steps * batch_size / (t_b - t_a), steps, t_b - t_a


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True,
                    help="dir with clean_trainset/ + noisy_trainset/")
    ap.add_argument("--batch_size", type=int, default=300)
    ap.add_argument("--epoch", type=int, default=14)
    ap.add_argument("--steps_per_call", type=int, default=4)
    ap.add_argument("--skip_epochs", type=int, default=2,
                    help="steady-state window starts after this many epochs "
                         "(epoch 1 builds the plans and the step's graph)")
    ap.add_argument("--loader_dtype", default="bfloat16",
                    help="collate-time cast ('' = loader default fp32); "
                         "bfloat16 halves the bytes copied to the card")
    ap.add_argument("--io_threads", type=int, default=4,
                    help="native wav-gather threads (0 = one per hardware thread)")
    ap.add_argument("--eoe_save_every", type=int, default=0,
                    help="epochs between EOE checkpoint saves "
                         "(0 = half the run, i.e. 2 saves)")
    ap.add_argument("--save_path", default="",
                    help="keep train artifacts here (default: temp dir)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the trainer's device (Def: cuda, which needs a card)")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="extra flags passed through to the trainer")
    return ap


def main(argv=None) -> dict:
    """Run the trainer and measure; prints and returns the JSON line's object."""
    args = build_parser().parse_args(argv)
    # the trainer runs from the package's directory
    corpus = os.path.abspath(args.corpus)
    save_path = os.path.abspath(args.save_path or tempfile.mkdtemp(prefix="ttb_"))
    cache_dir = os.path.join(save_path, "cache")
    eoe_every = args.eoe_save_every or max(1, args.epoch // 2)
    cmd = [
        # -u: unbuffered child stdout. Through a pipe, block buffering would flush
        # several epochs' log lines in one burst and quantize the host-side timestamps
        # that define the steady-state window
        sys.executable, "-u", "-m", "segan_pytorch_tpu_torch.train",
        "--clean_trainset", os.path.join(corpus, "clean_trainset"),
        "--noisy_trainset", os.path.join(corpus, "noisy_trainset"),
        "--save_path", save_path, "--cache_dir", cache_dir,
        "--batch_size", str(args.batch_size), "--epoch", str(args.epoch),
        "--compute_dtype", "bfloat16", "--no_bias", "--no_train_gen",
        "--steps_per_call", str(args.steps_per_call),
        "--io_threads", str(args.io_threads),
        "--eoe_save_every", str(eoe_every),
        "--slice_workers", "2", "--device", args.device,
    ]
    if args.loader_dtype:
        cmd += ["--loader_dtype", args.loader_dtype]
    cmd += args.extra

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    print("+", " ".join(cmd), flush=True)
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=ROOT, env=env)
    # (wall_time, iteration, epoch) per train-loop log line
    marks = []
    num_batches = None
    for line in proc.stdout:
        now = time.time() - t0
        sys.stdout.write(f"[{now:8.1f}s] {line}")
        sys.stdout.flush()
        m = LOG_RE.search(line)
        if m:
            it, bidx, nb, ep = map(int, m.groups())
            num_batches = nb
            marks.append((now, it, ep))
    rc = proc.wait()
    total_wall = time.time() - t0
    if rc != 0:
        raise SystemExit(f"the trainer exited {rc}")
    try:
        slices_per_sec, steps, wall_s = steady_state(
            marks, args.skip_epochs, args.batch_size)
    except ValueError as e:
        raise SystemExit(str(e))

    bytes_per_slice = 16384 * 2 * (2 if args.loader_dtype == "bfloat16" else 4)
    out = {
        "metric": "train.py end-to-end slices/sec (product path)",
        "value": round(slices_per_sec, 2),
        "unit": "slices/sec/chip",
        "batch_size": args.batch_size,
        "steps_per_call": args.steps_per_call,
        "loader_dtype": args.loader_dtype or "float32",
        "io_threads": args.io_threads,
        "steady_state_steps": steps,
        "steady_state_wall_s": round(wall_s, 2),
        "total_wall_s": round(total_wall, 2),
        "num_batches_per_epoch": num_batches,
        "h2d_bytes_per_slice": bytes_per_slice,
        "h2d_mb_per_sec_at_rate": round(
            slices_per_sec * bytes_per_slice / 1e6, 1),
        "device_only_slices_per_sec": None,
        # steady_state counts steps*batch_size slices; each epoch's ragged final batch
        # is mask-padded to batch_size, so real-data throughput is overstated by up to
        # (batch_size-1)/slices-per-epoch per epoch. Size the corpus to divide evenly.
        "note_ragged_tail": "per-step slices counted as full batch_size; "
                            "mask-padded tail batches inflate real-data "
                            "throughput slightly unless corpus%batch==0",
    }
    if not args.save_path:
        shutil.rmtree(save_path, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
