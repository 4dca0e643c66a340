"""Same-call timings of the per-layer kernel's routes at the SEGAN+ encoder's shapes, or
at Generator1D's (stride 2): the figures its route rule rests on
(``ops/kernels/conv1d_prelu.py`` ``_route``, ``_wgmma_plan``).

    python -m segan_pytorch_tpu_torch.tools.conv1d_routes [--batch 1 6 8 64 128 150 300]
        [--dtype bfloat16 float32] [--reps 10] [--plans] [--stride 4|2]

At each of the five encoder layers of B 16384-sample chunks, with x padded as G pads it
(``ops/conv.py`` ``reflect_pad_pitched``), or with ``--stride 2`` at each of the eleven
of the SEGAN v1 paper's Generator1D (K = 31, stride 2, 1 -> 16 ... 512 -> 1024 channels,
x padded by (15, 15) as its blocks pad it, ``zero_pad_pitched``), every route that takes
the shape ("rows",
"wgmma", "mma", "fma"; fp32 on the tensor cores by 3xTF32) runs forced into NaN-filled outputs
and is held against the plain version (2e-2 in bf16, 1e-4 in fp32), its launch read from
the counters; then the routes,
the plain version and cuDNN's ``F.conv1d`` (TF32 off) are timed in turns: CUDA events
around one wrapper call (host time included where the host is the slower) and around 10
back to back (a call's cost when calls follow each other, as in a G forward: the longer
of the host's time and the device's), the median and the interquartile range of
``--reps`` rounds after 2 warm-ups. It prints, per shape, each arm's time, the route the rule picks and the
fastest one, the bound (useful FLOPs at the dense peak or bytes at 3.35 TB/s, whichever
is longer) and the picked route's TFLOP/s; per batch the encoder sums of each route and
of the rule's picks. ``--plans`` also times, on the device alone (a CUDA graph of 10
calls through the kernel's entry point, ``encoder_fused_bench.graph_ms``), the dtype's
wgmma kernel at its other block tiles and split-K counts (the plan ``_wgmma_plan`` gives
among them), the mma.sync kernel at its tiles and split counts (``_mma_plan``'s among
them) and, in bf16 where the rows kernel takes the shape, its row tiles (the fewest of
at most 64 rows, and 2, 4 and 8 times as many, of at least 8 rows) and clusters (1, 2, 4,
8: its split-K slices; ``_rows_plan``'s among them). Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.conv import reflect_pad_pitched, zero_pad_pitched
from ..ops.kernels import build
from ..ops.kernels import conv1d_prelu as K
from .encoder_fused_bench import graph_ms

CHANS = [1, 64, 128, 256, 512, 1024]  # SEGAN+ encoder widths
# Generator1D's encoder widths at the v1 paper's configuration (chip_smoke.py G1D_V1)
G1D_CHANS = [1, 16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 1024]
WIDTHS = {4: CHANS, 2: G1D_CHANS}  # by stride
T = 16384  # samples per chunk
KW = 31
PEAK = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}  # fp32: 3xTF32
HBM_RATE = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
ROUTES = ("rows", "wgmma", "mma", "fma")


def times_in_turns(arms: Dict[str, Callable], reps: int, warmup: int = 2, calls: int = 1
                   ) -> Dict[str, list]:
    """Device ms per call of each arm (name -> fn): one turn of each per round, a pair of
    CUDA events around `calls` calls back to back, synchronised after each turn, after
    `warmup` rounds. With calls = 1 a time includes the host's time to launch when the
    host is the slower; with more, it is a call's cost when calls follow each other, the
    longer of the host's time and the device's."""
    times: Dict[str, list] = {name: [] for name in arms}
    for i in range(warmup + reps):
        for name, fn in arms.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            if i >= warmup:
                times[name].append(start.elapsed_time(end) / calls)
    return times


def median_iqr(samples) -> tuple:
    q = statistics.quantiles(samples, n=4)
    return statistics.median(samples), q[2] - q[0]


def route_of(run: Callable) -> str:
    """The route one wrapper call took, read from the counters."""
    before = (K.launches, K.launches_mma, K.launches_wgmma, K.launches_rows)
    run()
    moved = (K.launches - before[0], K.launches_mma - before[1],
             K.launches_wgmma - before[2], K.launches_rows - before[3])
    if moved[0] != 1:
        raise RuntimeError(f"{moved[0]} launches, not 1")
    return ("rows" if moved[3] else "wgmma" if moved[2] else
            ("mma" if moved[1] else "fma"))


def rel_err(got, ref) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def layer_inputs(B: int, layer: int, dtype, g: torch.Generator, bias: bool = False,
                 stride: int = 4):
    """x (padded by G's pitched pad, or at stride 2 by Generator1D's), w, b, a and T_out
    of encoder layer `layer` (0-4 of SEGAN+'s G, 0-10 of Generator1D's) for B chunks, on
    the card."""
    t_out = T // stride ** (layer + 1)
    cin, cout = WIDTHS[stride][layer], WIDTHS[stride][layer + 1]
    h = torch.randn((B, cin, stride * t_out), generator=g).to(dtype).cuda()
    x = (reflect_pad_pitched(h, KW // 2 - 1, KW // 2) if stride == 4
         else zero_pad_pitched(h, KW // 2, KW // 2))
    w = (torch.randn((cout, cin, KW), generator=g) / (cin * KW) ** 0.5).to(dtype).cuda()
    b = (torch.randn((cout,), generator=g) * 0.1).to(dtype).cuda() if bias else None
    a = (torch.rand((cout,), generator=g) * 0.3).to(dtype).cuda()
    return x, w, b, a, t_out


def routes_of(dtype, cin: int, cout: int, stride: int, t_out: int, B: int = 1) -> list:
    """The routes that take a layer shape with x in pitched rows."""
    return [r for r in ROUTES if r == "fma"
            or (r == "mma" and K._tensor_core_shape(dtype, cout, KW, stride, t_out))
            or (r == "wgmma" and K._wgmma_shape(dtype, cin, cout, KW, stride, t_out, True))
            or (r == "rows" and K._rows_shape(dtype, cin, cout, KW, stride)
                and K._rows_fits(B, cin, t_out))]


def plan_arm(x, w, b, a, t_out, tiles, splits, out, stride: int = 4,
             route: str = "wgmma") -> Callable:
    """A closure that launches the tensor-core kernel of `route` and x's dtype at a given
    block tile (wgmma: m_tiles; mma: warps_m; rows: (n, rows_per_tile)) and split-K count
    (rows: the cluster) through its entry point, into `out`: the weight copy, the split-K
    workspace and the arguments made once, the stream read at each call, so that a CUDA
    graph of its calls holds the kernel alone."""
    B, cin, t_in = x.shape
    cout = w.shape[0]
    fp32 = x.dtype == torch.float32
    head = (x.data_ptr(),)
    tail = (None if b is None else b.data_ptr(), a.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr())
    part = None
    if route == "rows":
        fn, wp = K._rows_entries()[1], K._rows_weights(w)
        args = head + (wp[2],) + tail + (*tiles, splits, B, cin, t_in, K._pitch(x), cout,
                                         t_out)
    else:
        if route == "wgmma":  # fp32: the split pair both fp32 routes take; bf16: permuted
            fn = K._wgmma_entry(x.dtype)
            wp = K._padded_weights(w) if fp32 else (K._permuted_weights(w),)
        else:
            fn = K._entries()[3 if fp32 else 2]
            wp = K._padded_weights(w) if fp32 else (K._padded_weights(w),)
        part = (torch.empty((splits, B, cout, t_out), dtype=torch.float32, device=x.device)
                if splits > 1 else None)
        args = head + tuple(v.data_ptr() for v in wp) + tail + (
            None if part is None else part.data_ptr(), tiles, splits, B, cin, t_in,
            K._pitch(x), cout, t_out, stride)

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{route} plan ({tiles}, {splits}): cudaError {err}")
        return wp, part  # alive while the closure is

    return run


def rows_candidates(B: int, cin: int, t_out: int, plan) -> list:
    """The rows kernel's ((n, rows_per_tile), cluster) plans `--plans` times: the fewest
    row tiles of at most ROWS_TILE_ROWS and 2, 4 and 8 times as many (of at least 8 rows),
    at each cluster whose shared memory fits; the rule's plan among them."""
    rows = B * t_out
    fewest = -(-rows // K.ROWS_TILE_ROWS)
    out = {((plan[0], plan[1]), plan[2])}
    for tiles in (fewest, 2 * fewest, 4 * fewest, 8 * fewest):
        if tiles > fewest and -(-rows // tiles) < 8:
            continue
        n, per = K._rows_width(rows, tiles)
        out |= {((n, per), c) for c in K.ROWS_CLUSTERS
                if c <= max(1, cin // 2) and K._rows_smem(n, per, c, B, cin, t_out)
                <= K.ROWS_MAX_SMEM}
    return sorted(out)


def plan_candidates(route: str, dtype, cin: int, plan, stride: int = 4) -> list:
    """The (tile, splits) plans `--plans` times for a route: wgmma's block tiles and 1-16
    split-K slices of at least 4 channels, mma.sync's tiles of warps_m 1, 2, 4 (and 8, which
    the kernel has at stride 2 alone) and 1-8 slices of at least MMA_MIN_SLICE channels;
    the rule's plan among them."""
    tiles, counts, least = ((K.WGMMA_TILES[dtype], (1, 2, 3, 4, 6, 8, 12, 16), 4)
                            if route == "wgmma" else (
                                (1, 2, 4, 8) if stride == 2 else (1, 2, 4),
                                (1, 2, 3, 4, 6, 8), K.MMA_MIN_SLICE))
    return sorted({(t, n) for t in tiles for n in counts if n == 1 or -(-cin // n) >= least}
                  | {tuple(plan)})


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the timings; returns {(dtype name, B, layer): {arm: (median ms, iqr ms)}}, with
    "pick" the rule's route and "sum" rows per batch."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 6, 8, 64, 128, 150, 300])
    ap.add_argument("--dtype", nargs="+", choices=("bfloat16", "float32"),
                    default=["bfloat16", "float32"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--stride", type=int, choices=(4, 2), default=4)
    args = ap.parse_args(argv)
    S = args.stride
    if not torch.cuda.is_available():
        raise RuntimeError("conv1d_routes needs a CUDA device")
    names = ("conv1d_prelu", "conv1d_wgmma", "conv1d_wgmma_tf32", "conv1d_rows")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        for name, (path, log) in zip(names, pool.map(build.build_library, names)):
            print(f"build: {name} -> {path}")
            if log:
                print(log.strip())
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(f"routes of fused_conv1d_prelu at stride {S} on {torch.cuda.get_device_name(0)} "
          f"({smi}), {sms} SMs; ms: median (interquartile range) of {args.reps} rounds in "
          f"turns", flush=True)
    g = torch.Generator().manual_seed(0)
    res = {}
    regret = {}  # route -> summed device ms of the rule's plans and of the fastest ones
    for dtype_name in args.dtype:
        dtype = getattr(torch, dtype_name)
        for B in args.batch:
            sums: Dict[str, float] = {}
            for layer in range(len(WIDTHS[S]) - 1):
                x, w, b, a, t_out = layer_inputs(B, layer, dtype, g, stride=S)
                cin, cout = x.shape[1], w.shape[0]
                shape = (B, cout, t_out)
                y_ref, pre_ref = K.conv1d_prelu_plain(x, w, b, a, S)
                pick = route_of(lambda: K.fused_conv1d_prelu(x, w, b, a, S))
                routes = routes_of(dtype, cin, cout, S, t_out, B)
                errs = {}
                for r in routes:
                    out = tuple(torch.full(shape, float("nan"), dtype=dtype, device="cuda")
                                for _ in range(2))
                    took = route_of(lambda: K._launch(x, w, b, a, S, t_out, out=out,
                                                      force=r))
                    torch.cuda.synchronize()
                    assert took == r, (r, took)
                    errs[r] = max(rel_err(out[0], y_ref), rel_err(out[1], pre_ref))
                    assert errs[r] <= TOL[dtype], f"B={B} enc{layer + 1} {r}: {errs[r]:.3e}"
                arms = {r: (lambda r=r: K._launch(x, w, b, a, S, t_out, force=r))
                        for r in routes}
                arms["plain"] = lambda: K.conv1d_prelu_plain(x, w, b, a, S)
                arms["cuDNN"] = lambda: F.conv1d(x, w, b, stride=S)
                for route in [r for r in ("rows", "wgmma", "mma") if args.plans and r in routes]:
                    if route == "rows":
                        rp = K._rows_plan(B, cin, cout, t_out, sms)
                        plan, candidates = ((rp[0], rp[1]), rp[2]), rows_candidates(
                            B, cin, t_out, rp)
                    else:
                        plan = (K._wgmma_plan(B, cin, cout, t_out, sms, dtype)
                                if route == "wgmma"
                                else K._mma_plan(B, cin, cout, t_out, sms, S, dtype))
                        candidates = plan_candidates(route, dtype, cin, plan, S)
                    out = (torch.empty(shape, dtype=dtype, device="cuda"),
                           torch.empty(shape, dtype=dtype, device="cuda"))
                    plans = {}
                    for tiles, splits in candidates:
                        for o in out:
                            o.fill_(float("nan"))
                        plans[tiles, splits] = plan_arm(x, w, b, a, t_out, tiles, splits,
                                                        out, S, route)
                        plans[tiles, splits]()
                        torch.cuda.synchronize()
                        e = max(rel_err(out[0], y_ref), rel_err(out[1], pre_ref))
                        assert e <= TOL[dtype], (B, layer, route, tiles, splits, e)
                    ptimes = graph_ms(plans, calls=10, reps=args.reps)
                    best = min(ptimes, key=ptimes.get)
                    print(f"{dtype_name} B={B} enc{layer + 1} {route} plans (tile, splits), "
                          f"device ms: " + ", ".join(f"{p[0]},{p[1]} {v:.4f}"
                                                    for p, v in ptimes.items())
                          + f"; rule {plan[0]},{plan[1]} {ptimes[plan]:.4f}, best "
                          f"{best[0]},{best[1]} {ptimes[best]:.4f} ({smi})", flush=True)
                    res[dtype_name, B, layer, route, "plans"] = ptimes
                    regret.setdefault(route, [0.0, 0.0])
                    regret[route][0] += ptimes[plan]
                    regret[route][1] += ptimes[best]
                stats = {n: median_iqr(v) for n, v in
                         times_in_turns(arms, args.reps).items()}
                dev = {n: median_iqr(v) for n, v in
                       times_in_turns(arms, args.reps, calls=10).items()}
                stats["pick"] = pick
                res[dtype_name, B, layer] = stats
                res[dtype_name, B, layer, "device"] = dev
                flops = 2.0 * B * t_out * cout * cin * KW
                nbytes = x.element_size() * (B * cin * x.shape[2] + cout * cin * KW + cout
                                             + 2 * B * cout * t_out)
                bound = 1e3 * max(flops / PEAK[dtype], nbytes / HBM_RATE)
                fastest = min(routes, key=lambda r: dev[r][0])
                for r in routes:
                    sums[r] = sums.get(r, 0.0) + stats[r][0]
                    sums[f"{r} device"] = sums.get(f"{r} device", 0.0) + dev[r][0]
                for col in ("plain", "cuDNN"):
                    sums[col] = sums.get(col, 0.0) + stats[col][0]
                sums["pick"] = sums.get("pick", 0.0) + stats[pick][0]
                sums["pick device"] = sums.get("pick device", 0.0) + dev[pick][0]
                sums["bound"] = sums.get("bound", 0.0) + bound
                print(f"{dtype_name} B={B} enc{layer + 1} rows {B * t_out}: " + ", ".join(
                    f"{n} {v[0]:.4f} ({v[1]:.4f})" for n, v in stats.items()
                    if n != "pick") + "; device (10 back to back): " + ", ".join(
                    f"{n} {v[0]:.4f} ({v[1]:.4f})" for n, v in dev.items())
                    + f"; bound {bound:.4f}; pick {pick}, fastest on the device "
                    f"{fastest}; pick {flops / dev[pick][0] * 1e-9:.1f} TFLOP/s; "
                    f"errs " + ", ".join(f"{r} {e:.2e}" for r, e in errs.items()),
                    flush=True)
                del x, w, y_ref, pre_ref
            res[dtype_name, B, "sum"] = sums
            print(f"{dtype_name} B={B} encoder sum: " + ", ".join(
                f"{n} {v:.4f}" for n, v in sums.items()) + " ms", flush=True)
    for route, (rule, fastest) in regret.items():
        print(f"{route} plans: the rule's picks {rule:.4f} ms summed over the shapes "
              f"against {fastest:.4f} for the fastest plans "
              f"(+{100 * (rule / fastest - 1):.1f} %)", flush=True)
    return res


if __name__ == "__main__":
    main()
