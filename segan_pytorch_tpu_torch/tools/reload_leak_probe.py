"""Does a retired serving generation give its memory back? The port's counterpart of
``tools/reload_leak_probe.py``, with the card's memory counted.

    python -m segan_pytorch_tpu_torch.tools.reload_leak_probe --g_ckpt G.ckpt \\
        --cfg_file train.opts [--iters 5] [--device cpu] [--out probe.json]

A first generation is built and kept, as the one a server goes on serving. Then, each
iteration, a second one is built and warmed the way ``/admin/reload`` builds it
(``serve.build_generation``), answers requests through its ``MicroBatcher`` and a
stream through its ``WindowBatcher``, is closed and dropped, and ``gc.collect()`` runs.
After each iteration the probe checks that

- weak references to the retired engine and to its two batchers are dead: no registry,
  cache or thread still holds the generation;
- ``torch.cuda.memory_allocated()`` is back at the one-generation baseline, within
  ``MEM_TOL`` (on the card; the caching allocator keeps freed blocks reserved, so
  ``memory_reserved`` would say nothing);
- the per-layer kernel's weight cache (``ops/kernels/conv1d_prelu._padded``) holds what
  it held at the baseline (the kept generation's weights) and nothing of the retired one.

It prints a line per iteration and a verdict, and reports the process's RSS per
generation, as the JAX probe does (the C allocator need not give freed pages back, so RSS
alone cannot tell a leak). Exit code 1 if a check fails.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import weakref

import numpy as np
import torch

from .. import serve
from ..ops.kernels import conv1d_prelu

MiB = 1024 * 1024
# How far memory_allocated may end from its one-generation baseline once a retired
# generation is collected (also phase 9's bound in chip_smoke.py). On an H100 at 700 W a
# full-width fp32 SEGAN+ generation held ~418 MiB (G's weights and the kernel's split
# copies); after each of five retirements in chip_smoke.py's phase 9 the readings stayed
# within 2.1 MiB of the baseline over five runs, and the probe's at 0 B. A leaked
# generation, or its padded weights alone (~170 MiB), is far outside the bound.
MEM_TOL = 8 * MiB


def rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return -1


def allocated(device: torch.device):
    """Bytes held by live tensors on the card; None on the CPU."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(device)


def exercise(gen, seed: int):
    """Requests through the MicroBatcher and a stream through the WindowBatcher."""
    cfg, engine, batcher, wb = gen
    S = cfg.slice_size
    rng = np.random.RandomState(seed)
    for n in (S, 3 * S // 2):
        batcher.enhance(0.1 * rng.randn(n).astype(np.float32),
                        rng=torch.Generator().manual_seed(seed))
    from ..utils.serving import StreamingEnhancer

    sess = StreamingEnhancer(engine, window=S, overlap=0.25,
                             rng=torch.Generator().manual_seed(seed), batcher=wb)
    sess.feed(0.1 * rng.randn(2 * S).astype(np.float32))
    sess.flush()


def probe(g_ckpt: str, cfg_file: str, device: str = "cuda", iters: int = 5,
          warm_seconds: float = 0.5) -> dict:
    """The probe's report: its rows, per iteration, and its verdict."""
    opts = serve.parse_args(["--g_pretrained_ckpt", g_ckpt, "--cfg_file", cfg_file,
                             "--warm_seconds", str(warm_seconds), "--device", device])
    dev = torch.device("cuda") if device == "cuda" else torch.device("cpu")
    state = serve.new_state(opts, dev)
    kept, _ = serve.build_generation(state, cfg_file, g_ckpt)
    exercise(kept, 0)
    gc.collect()
    base_mem, base_rss = allocated(dev), rss_kb()
    # the cache's entries now: the kept generation's and those of weights that other
    # code of the process holds, by weak reference
    base_keys = [weakref.ref(k) for k in conv1d_prelu._padded.keys()]
    base_padded = len(base_keys)
    rows = []
    for i in range(iters):
        gen, seconds = serve.build_generation(state, cfg_file, g_ckpt)
        exercise(gen, i + 1)
        two = allocated(dev)
        refs = [weakref.ref(gen[1]), weakref.ref(gen[2]), weakref.ref(gen[3])]
        serve.close_generation(gen)
        del gen
        gc.collect()
        mem = allocated(dev)
        stray = [k for k in conv1d_prelu._padded.keys()
                 if not any(r() is k for r in base_keys)]
        rows.append({"iter": i, "rss_kb": rss_kb(), "memory_allocated": mem,
                     "two_generations_allocated": two,
                     "generation_bytes": None if two is None else two - base_mem,
                     "load_s": seconds["load"], "warm_s": seconds["warm"],
                     "alive": [name for name, r in zip(("engine", "batcher", "win_batcher"),
                                                       refs) if r() is not None],
                     "padded_entries": len(conv1d_prelu._padded),
                     "stray_padded_entries": len(stray)})
        del stray
        row = rows[-1]
        print(f"[probe] generation {i}: rss {row['rss_kb']} kB, memory_allocated "
              f"{mem} B (baseline {base_mem}), with two generations {two} B, padded "
              f"entries {row['padded_entries']} (baseline {base_padded}), alive "
              f"{row['alive'] or 'none'}", flush=True)
    serve.close_generation(kept)
    tail = rows[iters // 2:]
    report = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "iters": iters,
        "baseline": {"rss_kb": base_rss, "memory_allocated": base_mem,
                     "padded_entries": base_padded},
        "rss_kb_per_generation_tail": (tail[-1]["rss_kb"] - tail[0]["rss_kb"])
        / max(1, len(tail) - 1) if tail else None,
        "rows": rows,
        "verdict": {
            "objects_collected": all(not r["alive"] for r in rows),
            "memory_released": base_mem is None or all(
                abs(r["memory_allocated"] - base_mem) <= MEM_TOL for r in rows),
            "padded_released": all(r["stray_padded_entries"] == 0 for r in rows),
        },
    }
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--g_ckpt", required=True)
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--warm_seconds", type=float, default=0.5)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None, help="write the report here as JSON")
    args = p.parse_args(argv)
    report = probe(args.g_ckpt, args.cfg_file, args.device, args.iters, args.warm_seconds)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print("[probe]", json.dumps(report["verdict"]), "rss_kb_per_generation_tail="
          f"{report['rss_kb_per_generation_tail']}", flush=True)
    return 0 if all(report["verdict"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
