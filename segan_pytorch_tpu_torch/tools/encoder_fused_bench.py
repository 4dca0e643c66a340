"""A/B of the chained enc2 + enc3 kernel on one CUDA device: the port of
``tools/encoder_fused_bench.py``.

    python -m segan_pytorch_tpu_torch.tools.encoder_fused_bench [--batch 300]
        [--dtype bfloat16|float32] [--device_batches B [B ...] [--clusters N ...]]

At the SEGAN+ enc2 + enc3 shapes (h1 (B, 64, 4096) -> 128 -> 256 channels, batch 300 by
default, the training batch) it times three arms, each returning (pre2, pre3, post3):

  plain chain : reflect pad -> conv + bias + PReLU twice in plain PyTorch (cuDNN, TF32 off)
  kernel x2   : the per-layer kernel (``fused_conv1d_prelu``) twice, each input padded
                as G's blocks pad it, into pitched rows (``reflect_pad_pitched``), so
                that each layer takes G's route (``wgmma`` at 300 chunks)
  fused 2+3   : the chained kernel (``fused_enc23_fwd``), post2 kept on chip

and prints each arm's time (CUDA events, median of 20 after 3 warm-ups), the route and
tile the chained kernel took (read from its launch counters: ``wgmma`` from
``WGMMA_MIN_ROWS`` enc3 rows in bf16, else ``mma.sync``; in fp32 ``wgmma`` by 3xTF32 from
``WGMMA_TF32_MIN_ROWS``, else ``mma.sync`` by 3xTF32) and the max |plain - fused| of each
output beside its relative error. With ``--device_batches`` it times instead, in the
dtype at each batch given, the device alone (``graph_ms``: 10 calls through the C entry
points captured into a CUDA graph and replayed) of the chained kernel on each route (in
fp32 the wgmma kernel at the cluster its rule picks, and at each of ``--clusters``), the
per-layer kernel twice with its pads (``device_arms``) and cuDNN's two convs: the figures
the routes' batch thresholds and the cluster rule are fitted to. The data is the JAX tool's:
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
import torch.nn.functional as F

from ..ops.conv import reflect_pad_pitched
from ..ops.kernels import conv1d_prelu as K
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
    """The per-layer kernel twice, post2 through device memory, each input padded into
    pitched rows as G's blocks pad it."""
    post2, pre2 = fused_conv1d_prelu(reflect_pad_pitched(h1, *EF.PAD), w2, b2, a2, EF.S)
    post3, pre3 = fused_conv1d_prelu(reflect_pad_pitched(post2, *EF.PAD), w3, b3, a3, EF.S)
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


def graph_ms(arms: Dict[str, Callable], calls: int = 10, reps: int = 10,
             warmup: int = 2) -> Dict[str, float]:
    """Device time in ms of one call of each of `arms` (name -> fn): `calls` calls of fn
    captured into one CUDA graph, whose replays are timed between a pair of CUDA events,
    in turns, median of `reps` rounds after `warmup`. A replay runs no host code, so this
    is the device's time wherever the host would be the slower. Each fn must launch on
    the current stream and make nothing it keeps (weights, plans) while it is captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in arms.values():
            for _ in range(warmup):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = {}
    for name, fn in arms.items():
        graphs[name] = torch.cuda.CUDAGraph()
        # relaxed: enc23_mma_kernel's launch sets its shared-memory size on every call
        with torch.cuda.graph(graphs[name], capture_error_mode="relaxed"):
            for _ in range(calls):
                fn()
    times: Dict[str, list] = {name: [] for name in arms}
    for i in range(warmup + reps):
        for name, g in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            if i >= warmup:
                times[name].append(start.elapsed_time(end) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def _layer_entry(x, w, b, a, out) -> Callable:
    """run(x2): the per-layer kernel through its C entry point on x2 (laid out as x) into
    out (y, pre), on the route and plan that the wrapper picks for x, the weights (and
    split-K workspace) made once, on the current stream. Its tensor-core routes only,
    bf16 or fp32 by 3xTF32: "wgmma", else ``mma.sync`` (which a bf16 "rows" call takes
    here)."""
    B, cin, t_in = x.shape
    cout, _, k = w.shape
    t_out = (t_in - k) // EF.S + 1
    pitched = K._pitch(x) % 8 == 0 and x.data_ptr() % 16 == 0
    route = K._route(x.dtype, B, cin, cout, k, EF.S, t_out, pitched)
    sms = K._sm_count(x.device.index)
    fp32 = x.dtype == torch.float32
    if route == "fma":
        raise ValueError("the tensor-core routes only, not the FMA kernel")
    if route == "wgmma":
        fn, plan = K._wgmma_entry(x.dtype), K._wgmma_plan(B, cin, cout, t_out, sms, x.dtype)
        wk = K._padded_weights(w) if fp32 else K._permuted_weights(w)
    else:
        fn = K._entries()[3 if fp32 else 2]
        plan = K._mma_plan(B, cin, cout, t_out, sms, EF.S, x.dtype)
        wk = K._padded_weights(w)
    wptrs = (wk[0].data_ptr(), wk[1].data_ptr()) if fp32 else (wk.data_ptr(),)
    part = (torch.empty((plan[1], B, cout, t_out), dtype=torch.float32, device=x.device)
            if plan[1] > 1 else None)
    ptr = lambda v: None if v is None else v.data_ptr()

    def run(x2):
        err = fn(x2.data_ptr(), *wptrs, ptr(b), a.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), ptr(part), *plan, B, cin, t_in, K._pitch(x2), cout,
                 t_out, EF.S, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"per-layer {route} launch failed: cudaError {err}")
        return out

    return run


def device_arms(h1, w2, b2, a2, w3, b3, a3, clusters: Sequence[int] = ()
                ) -> Dict[str, Callable]:
    """The arms whose device time ``graph_ms`` takes, each through C entry points with its
    weights, plans and outputs made once: the chained kernel on the dtype's ``wgmma``
    route (where it takes the widths; in fp32 at the cluster ``_wgmma_tf32_cluster``
    picks, and as "fused wgmma_tf32 CL<n>" at each of `clusters`) and on ``mma.sync``
    (bf16 ``enc23_mma_kernel``, fp32 ``enc23_tf32_kernel`` at the tile ``_tf32_tile``
    picks), the per-layer kernel twice as ``kernel_x2`` runs it (both pads into pitched
    rows included, each layer on the wrapper's route), and cuDNN's two convs alone on
    inputs padded once."""
    B, c1, t1 = h1.shape
    c2, c3 = w2.shape[0], w3.shape[0]
    fp32 = h1.dtype == torch.float32
    ptr = lambda v: None if v is None else v.data_ptr()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    empty = lambda *shape: torch.empty(shape, dtype=h1.dtype, device=h1.device)
    outputs = lambda: (empty(B, c2, t1 // 4), empty(B, c3, t1 // 16), empty(B, c3, t1 // 16))
    arms = {}
    if EF._wgmma_shape(h1.dtype, c2, c3, h1.data_ptr() % 16 == 0):
        if fp32:
            (w2b, w2s), (w3b, w3s), o = (EF._padded_weights(w2), EF._folded_weights(w3),
                                         outputs())

            def chained_wgmma_tf32(cl):
                err = EF._wgmma_tf32_entry()(
                    h1.data_ptr(), w2b.data_ptr(), w2s.data_ptr(), ptr(b2), a2.data_ptr(),
                    w3b.data_ptr(), w3s.data_ptr(), ptr(b3), a3.data_ptr(), o[0].data_ptr(),
                    o[1].data_ptr(), o[2].data_ptr(), cl, B, c1, t1, c2, c3, stream())
                assert err == 0, err
            rule = EF._wgmma_tf32_cluster(B, t1, K._sm_count(h1.device.index))
            arms["fused wgmma_tf32"] = lambda: chained_wgmma_tf32(rule)
            for cl in clusters:
                arms[f"fused wgmma_tf32 CL{cl}"] = lambda cl=cl: chained_wgmma_tf32(cl)
        else:
            w2p, w3f, o = K._permuted_weights(w2), EF._folded_weights(w3), outputs()

            def chained_wgmma():
                err = EF._wgmma_entry()(h1.data_ptr(), w2p.data_ptr(), ptr(b2),
                                        a2.data_ptr(), w3f.data_ptr(), ptr(b3),
                                        a3.data_ptr(), o[0].data_ptr(), o[1].data_ptr(),
                                        o[2].data_ptr(), B, c1, t1, c2, c3, stream())
                assert err == 0, err
            arms["fused wgmma"] = chained_wgmma
    om = outputs()
    if fp32:
        (w2b_, w2s_), (w3b_, w3s_) = K._padded_weights(w2), K._padded_weights(w3)
        tile = EF._tf32_tile(B, t1, K._sm_count(h1.device.index))

        def chained_tf32():
            err = EF._entries()[1](h1.data_ptr(), w2b_.data_ptr(), w2s_.data_ptr(), ptr(b2),
                                   a2.data_ptr(), w3b_.data_ptr(), w3s_.data_ptr(), ptr(b3),
                                   a3.data_ptr(), om[0].data_ptr(), om[1].data_ptr(),
                                   om[2].data_ptr(), tile, B, c1, t1, c2, c3, stream())
            assert err == 0, err
        arms["fused tf32"] = chained_tf32
    else:
        w2m, w3m = K._padded_weights(w2), K._padded_weights(w3)

        def chained_mma():
            err = EF._entries()[0](1, h1.data_ptr(), w2m.data_ptr(), ptr(b2), a2.data_ptr(),
                                   w3m.data_ptr(), ptr(b3), a3.data_ptr(), om[0].data_ptr(),
                                   om[1].data_ptr(), om[2].data_ptr(), B, c1, t1, c2, c3,
                                   stream())
            assert err == 0, err
        arms["fused mma.sync"] = chained_mma
    h1p = reflect_pad_pitched(h1, *EF.PAD)
    post2 = empty(B, c2, t1 // 4)
    enc2 = _layer_entry(h1p, w2, b2, a2, (post2, empty(B, c2, t1 // 4)))
    enc3 = _layer_entry(reflect_pad_pitched(post2, *EF.PAD), w3, b3, a3,
                        (empty(B, c3, t1 // 16), empty(B, c3, t1 // 16)))
    arms["kernel x2"] = lambda: enc3(reflect_pad_pitched(
        enc2(reflect_pad_pitched(h1, *EF.PAD))[0], *EF.PAD))
    p2p = reflect_pad_pitched(post2, *EF.PAD)
    arms["cuDNN x2"] = lambda: (F.conv1d(h1p, w2, b2, stride=EF.S),
                                F.conv1d(p2p, w3, b3, stride=EF.S))
    return arms


def route_taken(run: Callable, dtype: torch.dtype) -> Tuple[str, int]:
    """(route, tile) that the chained kernel took in run(), read from its counters:
    "wgmma_tf32" or "tf32" (3xTF32), "wgmma" or "mma" (bf16) or "fma", and its enc3 rows
    per block (per cluster on the fp32 wgmma route)."""
    counters = lambda: (EF.launches, EF.launches_tf32, EF.launches_tile16,
                        EF.launches_wgmma, EF.launches_wgmma_tf32)
    before = counters()
    run()
    launched, tf32, tile16, wgmma, wgmma_tf32 = (n - b for n, b in zip(counters(), before))
    if launched != 1:
        raise RuntimeError(f"the chained kernel launched {launched} times, not once")
    if tf32:
        return "tf32", 16 if tile16 else 32
    if wgmma:
        return "wgmma", EF.WGMMA_TILE
    if wgmma_tf32:
        return "wgmma_tf32", EF.WGMMA_TILE
    return ("mma" if dtype == torch.bfloat16 else "fma"), 32


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the A/B; returns {"ms": {arm: ms}, "max_abs": {...}, "rel": {...}, "route":
    ..., "tile": ...}, the errors of 'fused 2+3' against 'plain chain' by output and the
    chained kernel's route and tile. Beside the three arms, "fused mma.sync" times the
    chained kernel forced onto its ``mma.sync`` kernel (bf16 ``enc23_mma_kernel``, fp32
    ``enc23_tf32_kernel``), whose largest relative error against 'plain chain' is
    "rel_mma"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=300)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--device_batches", type=int, nargs="+", default=None,
                    help="time the arms' device alone at these batches instead")
    ap.add_argument("--clusters", type=int, nargs="*", default=[],
                    help="with --device_batches in fp32: also the fp32 wgmma kernel at "
                         "each of these cluster sizes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("encoder_fused_bench needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    if args.device_batches:
        res = {}
        for b in args.device_batches:
            res[b] = graph_ms(device_arms(*make_inputs(b, dtype=dtype, device="cuda"),
                                          clusters=args.clusters))
            print(f"{args.dtype} B={b} device ms on {torch.cuda.get_device_name(0)}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in res[b].items()), flush=True)
        return {"device_ms": res}
    inputs = make_inputs(args.batch, dtype=dtype, device="cuda")
    print(f"enc2+enc3, h1 {tuple(inputs[0].shape)} {args.dtype} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    res = {"ms": {}, "max_abs": {}, "rel": {}}
    outs = {}
    for name, arm in ARMS.items():
        outs[name] = arm(*inputs)
        res["ms"][name] = cuda_ms(lambda: arm(*inputs))
        print(f"{name:<12}: {res['ms'][name]:8.3f} ms", flush=True)
    forced = lambda: EF._launch(*inputs, force="tf32" if dtype == torch.float32 else "mma")
    mma_out = forced()
    res["ms"]["fused mma.sync"] = cuda_ms(forced)
    print(f"{'fused mma.sync':<12}: {res['ms']['fused mma.sync']:8.3f} ms", flush=True)
    res["rel_mma"] = max(float((o.float() - r.float()).abs().max() / r.float().abs().max())
                         for o, r in zip(mma_out, outs["plain chain"]))
    del mma_out
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
