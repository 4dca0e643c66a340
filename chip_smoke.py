#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (segan_pytorch_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no CPU fallback; it exits non-zero without a CUDA card
and when the port's package is not beside it):
  1. device facts: torch, nvcc and nvidia-smi (card name and power limit);
  2. build both hand-written kernel sources from segan_pytorch_tpu_torch/csrc/, one nvcc
     each, and the host libraries of native/ (the wav gather and the P.862 scorer), one
     g++ each, all started together;
  3. the per-layer kernel (fused_conv1d_prelu) vs its plain PyTorch version on the card,
     into NaN-filled outputs, at the five SEGAN+ encoder shapes for 1, 8, 64 and 300
     16384-sample chunks and at edge shapes (bias, T_in = 4 (T_out - 1) + 31, ragged,
     stride 1), in fp32 (TF32 off, relative error <= 1e-4) and bf16 (<= 2e-2), each on the
     route the wrapper picks, read from its counters (main-path shapes: the tensor cores,
     fp32 by 3xTF32; the ragged and stride-1 shapes: FMA), and on the FMA route forced; in
     fp32 enc5 at 64 and 300 chunks also vs a float64 conv (<= 1e-4). Times in turns (CUDA
     events, median of 20 after 3 warm-ups): both routes, plain and cuDNN's F.conv1d
     alone, in each dtype; TFLOP/s, share of peak, bounds, and encoder sums per batch. At
     64 and 300 chunks the tensor cores must take at most half the FMA route's time in
     bf16 and no more than it in fp32;
  3b. the chained kernel (fused_enc23_fwd: fp32 on the tensor cores by 3xTF32 where C2
     and C3 are multiples of 8, else on FMAs; bf16 on mma.sync) vs enc23_plain, into
     NaN-filled outputs, at the SEGAN+ enc2+enc3 widths (h1 (B, 64, 4096) -> 128 -> 256)
     for B = 1, 8 and 300, with and without bias, and at two narrow odd shapes, in fp32
     and bf16 with the same limits, each route and tile read from the counters: fp32 on
     the route and tile the wrapper picks, then at tiles 16 and 32 and on the FMA kernel
     forced; at B = 300 also vs the per-layer kernel chain (bf16: bit for bit) and fp32
     pre3 vs a float64 chain (<= 1e-4). Times in turns at B = 1, 8 and 300 of the A/B
     tool's three arms, fp32 at both tiles and on the FMA kernel forced, and cuDNN's two
     convs alone; in fp32 at B >= 8 the tensor cores must take no more time than the FMA
     kernel. An fp32 call with C3 = 36 must take the FMA kernel and be right; a bf16 one
     must raise ValueError (whole n8 tiles) and launch nothing. Both fp32 tiles in turns
     at B = 16, 32, 48 and 64, where the tile rule switches;
  3c. the A/B tool (python -m segan_pytorch_tpu_torch.tools.encoder_fused_bench) at its
     defaults, batch 300 bf16, then with --dtype float32: both kernels must launch in it,
     the chained kernel on mma.sync in bf16 and on the 3xTF32 route at tile 32 in fp32,
     and agree with the plain chain within 2e-2 and 1e-4;
  3d. the TF32 policy: with cuDNN's TF32 on process-wide, a bare fp32 GDeconv1DBlock and
     Conv1dPReLU's backward convs on the card vs float64 on the CPU (<= 1e-4); the
     deconv's error with the ops' policy bypassed is printed beside it;
  4. the slice: a full-width SEGAN+ generator (seeded init, PReLU slopes U(0, 0.3))
     saved as a reference-format .ckpt + train.opts, then the port's clean.py CLI
     (--device cuda) on 8 synthetic wavs with --batch_utts 1 and 4 in fp32 and 4 in bf16.
     Checks: outputs finite and of their inputs' lengths, the kernel launched 5 times per
     G forward, all on the tensor cores (fp32 counted apart), batched == sequential, and
     the card's generate() == a CPU copy's (plain ops) within 1e-3 relative. Prints audio
     seconds enhanced per wall second, the device memory that the first fp32 forward
     keeps (the split weights), and G chunks/s at batch 64, fp32 and bf16, each on both
     routes of the per-layer kernel, in turns.
  5. the train path (models/segan.py SEGAN.train_step), every check fatal:
     5a. Conv1dPReLU's backward (dx, dw, db, da) on the card vs autograd of
     conv1d_prelu_plain on the card at the five encoder shapes at B = 8 and enc2 at
     B = 300, fp32 (TF32 off, <= 1e-4) and bf16 (<= 2e-2), slopes U(0, 0.3), the upstream
     gradient gy zeroed where pre lies within the limit of 0 (there the PReLU's branch
     depends on the last bit); then per dtype one RMSprop and one Adam step (the port's
     build_optimizer) on w in place, after which the kernel must equal the plain version
     with the new w (its padded weights cached by w's version must not be stale);
     5b. a full-width SEGAN+ G + D (--no_bias, slopes U(0, 0.3)), one fp32 step at B = 4
     (one row masked) on the card and on a CPU copy (oneDNN off), same init, batch, z and
     phase draws, both held against the step in float64 on the CPU: the card's losses
     (g_adv in the step with D's learning rate 0, below) and Genh <= 1e-3 relative; D's
     gradients, all tensors together, within max(1e-3, 4 x the CPU fp32 ones' error) in
     L2 and each within max(1e-2, 4 x the CPU's) (the step's per-channel gradient sums
     cancel; D's conv biases, which feed a BatchNorm
     and so have a true gradient of 0, are checked to be noise). G's step gradients go
     through D after its RMSprop step and through PReLU kinks, where last-bit differences
     flip a sign: printed; G's backward from a fixed gradient of Genh, card vs float64,
     each tensor <= 1e-3; with D's learning rate 0, g_adv <= 1e-3 and G's step gradients
     <= 5e-2 all together;
     5c. the step at full width, batch 300, fp32 and bf16: 3 warm-up steps, then 10 timed
     by CUDA events with the kernel's counters set to 0 just before and read just after
     (5 launches per step, all on the tensor cores); losses finite; slices/s, the median
     split into G forward / D update / G update, peak device memory; then
     `python -m segan_pytorch_tpu_torch.bench --steps 5 --warmup 2` in bf16 and fp32.
  6. the training run at full SEGAN+ width (`python -m segan_pytorch_tpu_torch.train`'s
     main in-process, batch 300, fp32, --no_bias, a log point per step): a synthetic
     corpus of 16 x 20 s pairs (608 slices: batches of 300, 300 and a ragged 8) and 2 x
     4 s validation pairs; one epoch, then --resume to epoch 2. Every check fatal: finite
     losses at each log point, "Resumed from step 3" and iterations 4-6 in the second run,
     the EOE and best-val indices and payloads (the EOE payload with the optimizer state
     and 6 steps), fused_conv1d_prelu launched 5 x (train steps + G forwards of the
     training samples and of evaluate) times over both runs, all 3xTF32 on the tensor
     cores (read from its counters, set to 0 just before the first run), the kernel on the
     encoder weights that resume() loads equal to the plain version (<= 1e-4, and away from
     a fresh G's), and the port's clean CLI on the validation wavs with the last EOE G.
     Prints the PESQ backend, each run's batch-loop, evaluate and checkpoint-save seconds
     and data wait per step, and the warm loop's slices/s beside 5c's and the bench's.
The line before the last is the JSON kernel report (launches of fused_conv1d_prelu from
phase 4, train_launches_per_step from 5c and train_run_launches from phase 6, its times
the bf16 encoder sum at 64 chunks
and, under fp32_*, the fp32 one;
launches of fused_enc23_fwd from phase 3c, launches_tf32 those of its fp32 run, its times
the tool's at batch 300 in bf16 and, under fp32_*, in fp32, library_ms cuDNN's two convs
from phase 3b); the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 1234
SR = 16000
FP32_TOL = 1e-4   # fp32 sums in another order than cuDNN's (TF32 off)
BF16_TOL = 2e-2   # bf16 outputs: one rounding of 2^-8 relative, plus the inputs'
SLICE_TOL = 1e-3  # whole G, card vs CPU: 10 layers of reordered fp32 sums
KERNELS = [  # the fixed fields of the kernels line, in its order
    dict(name="fused_conv1d_prelu", route="cuda",
         source="segan_pytorch_tpu_torch/csrc/conv1d_prelu.cu",
         replaces="segan_pytorch_tpu/ops/pallas/conv1d.py:127"),
    dict(name="fused_enc23_fwd", route="cuda",
         source="segan_pytorch_tpu_torch/csrc/encoder_fused.cu",
         replaces="segan_pytorch_tpu/ops/pallas/encoder_fused.py:112"),
]


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|: an absolute tolerance would pass anything once the
    N(0, 0.02) weights have shrunk the deep activations. NaN (an output row the kernel
    never wrote) makes it NaN, which fails every bound."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def worst(values) -> float:
    """The largest of the values, NaN if any is NaN: the built-in max() drops a NaN
    that is not in first place, and would pass an output the kernel left unwritten."""
    return float(np.max(list(values)))


def nan_outputs(*shapes, dtype):
    """Outputs filled with NaN, so that a row the kernel does not write cannot pass for
    a right one left behind in the allocator's memory."""
    import torch

    return tuple(torch.full(s, float("nan"), dtype=dtype, device="cuda") for s in shapes)


def phase_device():
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import build

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python {sys.version.split()[0]}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
    print(smi)
    return smi


def phase_build():
    from segan_pytorch_tpu_torch.ops.kernels import build

    names = ("conv1d_prelu", "encoder_fused")
    hosts = ("segan_io", "pesq862")  # the C++ wav gather and P.862 scorer of native/
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + len(hosts)) as pool:  # one compiler per source
        kernels = [pool.submit(build.build_library, name) for name in names]
        libs = [pool.submit(build.build_host_library, name) for name in hosts]
        built = [f.result() for f in kernels]
        host_paths = [f.result() for f in libs]
    secs = time.perf_counter() - t0
    for name, (path, log) in zip(names, built):
        print(f"build: {name} ({'compiled' if log is not None else 'already built'}) "
              f"-> {path}")
        if log:
            print(log.strip())
    for name, path in zip(hosts, host_paths):
        print(f"build: native/{name}.cpp -> {path}")
    print(f"build: {len(names)} kernels and {len(hosts)} host libraries in {secs:.2f} s")


BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s of an H100 SXM at 700 W
FP32_PEAK = 67e12   # fp32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12  # dense TF32 tensor-core FLOP/s
HBM_RATE = 3.35e12  # device memory bytes/s


def enc23_work(b, t1, c1, c2, c3, has_bias, itemsize):
    """(operations, bytes) of fused_enc23_fwd: the two convs' useful FLOPs; h1, the
    weights, biases and slopes read once, pre2, pre3 and post3 written once."""
    kw = 31
    flops = 2.0 * b * kw * (t1 // 4 * c2 * c1 + t1 // 16 * c3 * c2)
    elems = (b * c1 * t1 + kw * (c2 * c1 + c3 * c2) + (2 if has_bias else 1) * (c2 + c3)
             + b * c2 * t1 // 4 + 2 * b * c3 * t1 // 16)
    return flops, itemsize * elems


def bound_ms(flops, nbytes, peak) -> float:
    """The least time the card could take: the larger of the operations at `peak` and
    the bytes (each input read once, each output written once) at HBM_RATE."""
    return 1e3 * max(flops / peak, nbytes / HBM_RATE)


def phase_kernel():
    """Kernel vs plain on the card, at the encoder shapes of 1, 8, 64 and 300 chunks and
    at edge shapes; each route's choice read from its counters. Returns the bf16 and
    fp32 results at B = 64 for the kernels line."""
    import torch
    import torch.nn.functional as F
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import ms_in_turns

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED)
    T, Kw, S = 16384, 31, 4
    chans = [1, 64, 128, 256, 512, 1024]
    cases = []  # (label, B, Cin, T_in, Cout, K, stride, bias, main path, bf16 route)
    for B in (1, 8, 64, 300):
        t = T
        for i in range(5):
            t //= S
            cases.append((f"B={B} enc{i + 1}", B, chans[i], S * t + Kw - 2, chans[i + 1], Kw,
                          S, False, True, "mma"))
    cases += [
        ("B=8 enc3 bias", 8, 128, 1053, 256, Kw, S, True, False, "mma"),
        ("T_in=91 bias", 3, 512, 91, 1024, Kw, S, True, False, "mma"),  # reads x[91]: 0
        ("T_in=1051 bias", 2, 128, 1051, 256, Kw, S, True, False, "mma"),
        ("ragged T_out=243", 3, 5, 1000, 70, Kw, S, True, False, "fma"),
        ("stride 1", 2, 48, 300, 40, Kw, 1, True, False, "fma"),
    ]
    sums = {}  # (B, column) -> ms summed over the five encoder layers
    max_abs = {}  # B -> max |mma - plain| over the bf16 encoder layers
    max_abs32 = 0.0  # max |tensor cores - plain| over the fp32 encoder layers at B = 64
    print(f"{'layer':>16} {'x shape':>19} {'Cout':>5} {'T_out':>5} | {'fp32':>8} "
          f"{'fp32 fma':>8} {'bf16':>8} {'bf16 fma':>8} | {'tf32 ms':>8} {'fma ms':>8} "
          f"{'plain':>8} {'cuDNN':>8} | {'mma ms':>8} {'fma ms':>8} {'plain':>8} "
          f"{'cuDNN':>8} | {'TFLOP/s':>7} {'peak':>6} | fp32 TFLOP/s | bound ms fp32, bf16")
    for label, b, cin, t_in, cout, kw, s, has_bias, main, route in cases:
        x = torch.randn((b, cin, t_in), generator=g).cuda()
        w = (torch.randn((cout, cin, kw), generator=g) / (cin * kw) ** 0.5).cuda()
        bias = (torch.randn((cout,), generator=g) * 0.1).cuda() if has_bias else None
        a = (torch.rand((cout,), generator=g) * 0.3).cuda()
        t_out = K._check(x, w, bias, a, s)
        shape = (b, cout, t_out)
        assert t_out == (t_in - kw) // s + 1, (label, t_out)
        if (t_in - kw) % s == 0 and route == "mma":
            assert s * (t_out - 1) + K.KP - 1 == t_in, label  # the zero tap reads x[T_in]
        # fp32: the route that _route picks (3xTF32 on the tensor cores at the main-path
        # shapes), read from the counters, then the FMA kernel forced
        before = (K.launches_mma, K.launches_tf32)
        y, pre = K._launch(x, w, bias, a, s, t_out,
                           out=nan_outputs(shape, shape, dtype=x.dtype))
        y_ref, pre_ref = K.conv1d_prelu_plain(x, w, bias, a, s)
        torch.cuda.synchronize()
        took = ("mma" if (K.launches_mma, K.launches_tf32) == (before[0] + 1, before[1] + 1)
                else "fma")
        assert took == route, f"{label}: fp32 took the {took} route, not {route}"
        e32 = worst([rel_err(y, y_ref), rel_err(pre, pre_ref)])
        assert e32 <= FP32_TOL, f"{label}: fp32 {took} vs plain rel err {e32:.3e} > {FP32_TOL}"
        if main and cin == 512 and b in (64, 300):
            # the deepest layer against float64: the tensor cores' own fp32 sums do not
            # promise to round to nearest, and the plain version has errors of its own
            pre64 = F.conv1d(x.double(), w.double(), None, stride=s)
            e64, e64_plain = rel_err(pre, pre64), rel_err(pre_ref, pre64)
            print(f"{label}: fp32 pre vs a float64 conv: rel err {e64:.3e} on the {took} "
                  f"route, {e64_plain:.3e} for the plain version", flush=True)
            assert e64 <= FP32_TOL, f"{label}: fp32 {took} vs float64 rel err {e64:.3e}"
            del pre64
        if main and b == 64:
            max_abs32 = worst([max_abs32, float((y - y_ref).abs().max()),
                               float((pre - pre_ref).abs().max())])
        del y, pre
        e32f = float("nan")
        arms32 = {took: lambda: K.fused_conv1d_prelu(x, w, bias, a, s)}
        if route == "mma":
            yf, pref = K._launch(x, w, bias, a, s, t_out, force_fma=True,
                                 out=nan_outputs(shape, shape, dtype=x.dtype))
            torch.cuda.synchronize()
            e32f = worst([rel_err(yf, y_ref), rel_err(pref, pre_ref)])
            assert e32f <= FP32_TOL, f"{label}: fp32 fma vs plain rel err {e32f:.3e}"
            del yf, pref
            arms32["fma"] = lambda: K._launch(x, w, bias, a, s, t_out, force_fma=True)
        del y_ref, pre_ref
        arms32["plain"] = lambda: K.conv1d_prelu_plain(x, w, bias, a, s)
        arms32["cuDNN"] = lambda: F.conv1d(x, w, bias, stride=s)
        t32 = ms_in_turns(arms32)
        # bf16: the route that _route picks, then the FMA kernel forced
        hb = [v.bfloat16() if v is not None else None for v in (x, w, bias, a)]
        del x, w
        before = K.launches_mma
        yb, preb = K._launch(*hb, s, t_out,
                             out=nan_outputs(shape, shape, dtype=torch.bfloat16))
        yb_ref, preb_ref = K.conv1d_prelu_plain(*hb, s)
        torch.cuda.synchronize()
        took = "mma" if K.launches_mma == before + 1 else "fma"
        assert took == route, f"{label}: bf16 took the {took} route, not {route}"
        assert yb.dtype == torch.bfloat16
        e16 = worst([rel_err(yb, yb_ref), rel_err(preb, preb_ref)])
        assert e16 <= BF16_TOL, f"{label}: bf16 {took} vs plain rel err {e16:.3e} > {BF16_TOL}"
        if main:
            max_abs[b] = worst([max_abs.get(b, 0.0), float((yb - yb_ref).abs().max()),
                                float((preb - preb_ref).abs().max())])
        del yb, preb
        e16f = float("nan")
        arms = {"mma": lambda: K.fused_conv1d_prelu(*hb, s)}
        if route == "mma":
            yf, pref = K._launch(*hb, s, t_out, force_fma=True,
                                 out=nan_outputs(shape, shape, dtype=torch.bfloat16))
            torch.cuda.synchronize()
            e16f = worst([rel_err(yf, yb_ref), rel_err(pref, preb_ref)])
            assert e16f <= BF16_TOL, f"{label}: bf16 fma vs plain rel err {e16f:.3e}"
            del yf, pref
            arms["fma"] = lambda: K._launch(*hb, s, t_out, force_fma=True)
        else:
            arms = {"fma": arms["mma"]}
        del yb_ref, preb_ref
        arms["plain"] = lambda: K.conv1d_prelu_plain(*hb, s)
        arms["cuDNN"] = lambda: F.conv1d(hb[0], hb[1], hb[2], stride=s)
        t16 = ms_in_turns(arms)
        flops = 2.0 * b * t_out * cout * cin * kw
        nbytes = 2 * (b * cin * t_in + cout * cin * kw + (2 if has_bias else 1) * cout
                      + 2 * b * cout * t_out)  # in bf16: x, w, b, a read, y, pre written
        kernel_ms = t16.get("mma", t16["fma"])
        if cin == 1:  # bound by memory: bytes/s and the share of the memory rate
            rate = nbytes / kernel_ms * 1e3
            rate = f"{rate * 1e-12:.3f} TB/s {rate / HBM_RATE:6.1%}"
        else:  # bound by operations: TFLOP/s and the share of the bf16 peak
            rate = flops / kernel_ms * 1e3
            rate = f"{rate * 1e-12:7.1f} {rate / BF16_PEAK:6.1%}"
        tc32 = t32.get("mma", t32["fma"])
        rate32 = f"{flops / tc32 * 1e-9:7.1f}"  # useful fp32 TFLOP/s
        # fp32: the smaller of the FMA pipes' bound and the 3xTF32 tensor cores' (three
        # TF32 products per fp32 product); bytes of fp32 x, w, b, a, y and pre
        b32 = min(bound_ms(flops, 2 * nbytes, FP32_PEAK),
                  bound_ms(3 * flops, 2 * nbytes, TF32_PEAK))
        b16 = bound_ms(flops, nbytes, BF16_PEAK)
        if main:
            for col, v in [("fp32 tc", t32["mma"]), ("fp32 fma", t32["fma"]),
                           ("fp32 plain", t32["plain"]), ("fp32 cuDNN", t32["cuDNN"]),
                           ("fp32 bound", b32), ("bf16 mma", t16["mma"]),
                           ("bf16 fma", t16["fma"]), ("bf16 plain", t16["plain"]),
                           ("bf16 cuDNN", t16["cuDNN"]), ("bf16 bound", b16)]:
                sums[b, col] = sums.get((b, col), 0.0) + v
        print(f"{label:>16} {str((b, cin, t_in)):>19} {cout:>5} {t_out:>5} | {e32:8.1e} "
              f"{e32f:8.1e} {e16:8.1e} {e16f:8.1e} | {t32.get('mma', float('nan')):8.4f} "
              f"{t32['fma']:8.4f} {t32['plain']:8.4f} {t32['cuDNN']:8.4f} | "
              f"{t16.get('mma', float('nan')):8.4f} {t16['fma']:8.4f} {t16['plain']:8.4f} "
              f"{t16['cuDNN']:8.4f} | {rate} | {rate32} | {b32:.4f} {b16:.4f}", flush=True)
        del hb
    for b in (1, 8, 64, 300):
        print(f"encoder sum B={b}: " + ", ".join(
            f"{col} {sums[b, col]:.4f}" for col in ("fp32 tc", "fp32 fma", "fp32 plain",
                                                    "fp32 cuDNN", "fp32 bound", "bf16 mma",
                                                    "bf16 fma", "bf16 plain", "bf16 cuDNN",
                                                    "bf16 bound"))
              + f" ms; fp32 tc / fma {sums[b, 'fp32 tc'] / sums[b, 'fp32 fma']:.3f}, "
              f"tc / cuDNN {sums[b, 'fp32 tc'] / sums[b, 'fp32 cuDNN']:.3f}; "
              f"bf16 mma / fma {sums[b, 'bf16 mma'] / sums[b, 'bf16 fma']:.3f}, "
              f"mma / cuDNN {sums[b, 'bf16 mma'] / sums[b, 'bf16 cuDNN']:.3f}")
        if b >= 64:  # the tensor cores must at least halve the FMA route's time in bf16,
            # and in fp32 (3xTF32) be no slower than it
            assert sums[b, "bf16 mma"] <= 0.5 * sums[b, "bf16 fma"], (b, sums)
            assert sums[b, "fp32 tc"] <= sums[b, "fp32 fma"], (b, sums)
    return dict(max_abs_err=max_abs[64], ms=sums[64, "bf16 mma"],
                plain_ms=sums[64, "bf16 plain"], bound_ms=sums[64, "bf16 bound"],
                bound_by="operations", library_ms=sums[64, "bf16 cuDNN"],
                fp32_max_abs_err=max_abs32, fp32_ms=sums[64, "fp32 tc"],
                fp32_fma_ms=sums[64, "fp32 fma"], fp32_plain_ms=sums[64, "fp32 plain"],
                fp32_bound_ms=sums[64, "fp32 bound"], fp32_library_ms=sums[64, "fp32 cuDNN"])


def phase_enc23():
    """The chained kernel vs enc23_plain on the card, into NaN-filled outputs, each route
    read from its counters: fp32 on the 3xTF32 tensor cores at both tiles and on the FMA
    kernel forced, bf16 on mma.sync; at B = 300 also vs the per-layer kernel chain and
    fp32 pre3 vs a float64 chain. Times in turns. Returns the max abs errors at the SEGAN+
    widths and the B = 300 times for the kernels line."""
    import torch
    import torch.nn.functional as F
    from segan_pytorch_tpu_torch.ops.conv import reflect_pad_1d
    from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
    from segan_pytorch_tpu_torch.ops.kernels.conv1d_prelu import conv1d_prelu_plain
    from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [  # (label, B, T1, C1, C2, C3, bias, SEGAN+ widths)
        ("B=1", 1, 4096, 64, 128, 256, False, True),
        ("B=8", 8, 4096, 64, 128, 256, False, True),
        ("B=300", 300, 4096, 64, 128, 256, False, True),
        ("B=8 bias", 8, 4096, 64, 128, 256, True, True),
        ("narrow T1=64", 3, 64, 5, 24, 40, True, False),
        ("ragged tile T1=592", 2, 592, 5, 24, 40, False, False),
    ]
    timed = ("B=1", "B=8", "B=300")
    max_abs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    at300 = {}
    counters = lambda: (EF.launches, EF.launches_tf32, EF.launches_tile16)
    start = counters()

    def launched(run, want):
        """run() and check that it made one launch of the route and tile `want`."""
        before = counters()
        out = run()
        torch.cuda.synchronize()
        moved = tuple(n - b for n, b in zip(counters(), before))
        assert moved == want, f"launches (all, tf32, tile 16) moved by {moved}, not {want}"
        return out

    print(f"{'case':>18} {'dtype':>8} {'tile':>4} | {'rel err':>9} {'tile 16':>9} "
          f"{'tile 32':>9} {'fma':>9} {'vs x2':>9} {'vs f64':>9}")
    for label, b, t1, c1, c2, c3, has_bias, full in cases:
        h1 = torch.randn((b, c1, t1), generator=g).cuda()
        w2 = (torch.randn((c2, c1, EF.K), generator=g) / (c1 * EF.K) ** 0.5).cuda()
        w3 = (torch.randn((c3, c2, EF.K), generator=g) / (c2 * EF.K) ** 0.5).cuda()
        b2, b3 = ((torch.randn((c,), generator=g) * 0.1).cuda() if has_bias else None
                  for c in (c2, c3))
        a2, a3 = ((torch.rand((c,), generator=g) * 0.3).cuda() for c in (c2, c3))
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            args = [v.to(dtype) if v is not None else None
                    for v in (h1, w2, b2, a2, w3, b3, a3)]
            EF._check(*args)
            shapes = [(b, c2, t1 // 4), (b, c3, t1 // 16), (b, c3, t1 // 16)]
            fp32 = dtype == torch.float32
            tile = EF._tf32_tile(b, t1, sms) if fp32 else 32
            # the route that _route picks: fp32 on the 3xTF32 kernel at the tile by batch
            want = (1, 1, int(tile == 16)) if fp32 else (1, 0, 0)
            got = launched(lambda: EF._launch(*args, out=nan_outputs(*shapes, dtype=dtype)),
                           want)
            ref = EF.enc23_plain(*args)
            err = worst(rel_err(o, r) for o, r in zip(got, ref))
            assert err <= tol, f"{label} {dtype}: chained vs plain rel err {err:.3e} > {tol}"
            if full:
                max_abs[dtype] = worst([max_abs[dtype]] + [float((o - r).abs().max())
                                                           for o, r in zip(got, ref)])
            errs = {}
            if fp32:  # both tiles, then the FMA kernel forced
                for t in (16, 32):
                    o = launched(lambda: EF._launch(*args, tile=t, out=nan_outputs(
                        *shapes, dtype=dtype)), (1, 1, int(t == 16)))
                    errs[f"tile {t}"] = worst(rel_err(v, r) for v, r in zip(o, ref))
                o = launched(lambda: EF._launch(*args, force_fma=True,
                                                out=nan_outputs(*shapes, dtype=dtype)),
                             (1, 0, 0))
                errs["fma"] = worst(rel_err(v, r) for v, r in zip(o, ref))
                del o
                bad = {k: e for k, e in errs.items() if not e <= tol}
                assert not bad, f"{label} fp32 vs plain rel err over {tol}: {bad}"
            if b == 300:
                errs["x2"] = worst(rel_err(o, r) for o, r in zip(got, bench.kernel_x2(*args)))
                assert errs["x2"] <= tol, f"{label} {dtype}: chained vs kernel x2 {errs['x2']}"
                # bf16: the same MMAs in the same order as the per-layer kernel twice
                assert fp32 or errs["x2"] == 0, f"bf16 chained vs kernel x2 {errs['x2']}"
                if fp32:  # the deepest sum, pre3, against a float64 chain
                    ref64 = EF.enc23_plain(*[v.double() if v is not None else None
                                             for v in args])
                    errs["f64"] = rel_err(got[1], ref64[1])
                    e_plain = rel_err(ref[1], ref64[1])
                    del ref64
                    print(f"{label}: fp32 pre3 vs a float64 chain: rel err {errs['f64']:.3e} "
                          f"(the plain chain {e_plain:.3e})")
                    assert errs["f64"] <= FP32_TOL, f"{label}: pre3 vs float64 {errs['f64']}"
            del got, ref
            print(f"{label:>18} {str(dtype)[6:]:>8} {tile:>4} | {err:9.2e} " + " ".join(
                f"{errs.get(k, float('nan')):9.2e}"
                for k in ("tile 16", "tile 32", "fma", "x2", "f64")), flush=True)
            if label not in timed:
                continue
            # in turns: the arms of the A/B tool, fp32 at both tiles and on the FMA kernel
            # forced, and cuDNN's two convs alone (the library's share of the plain chain)
            h1p = reflect_pad_1d(args[0], *EF.PAD)
            p2p = reflect_pad_1d(conv1d_prelu_plain(h1p, *args[1:4], EF.S)[0], *EF.PAD)
            arms = {name: lambda arm=arm: arm(*args) for name, arm in bench.ARMS.items()}
            if fp32:
                for t in (16, 32):
                    arms[f"tile {t}"] = lambda t=t: EF._launch(*args, tile=t)
                arms["fma"] = lambda: EF._launch(*args, force_fma=True)
            arms["cuDNN x2"] = lambda: (F.conv1d(h1p, args[1], args[2], stride=EF.S),
                                        F.conv1d(p2p, args[4], args[5], stride=EF.S))
            ms = bench.ms_in_turns(arms)
            del h1p, p2p
            flops, nbytes = enc23_work(b, t1, c1, c2, c3, has_bias, args[0].element_size())
            # fp32: the smaller of the FMA pipes' bound and the 3xTF32 tensor cores'
            ms["bound"] = (min(bound_ms(flops, nbytes, FP32_PEAK),
                               bound_ms(3 * flops, nbytes, TF32_PEAK)) if fp32
                           else bound_ms(flops, nbytes, BF16_PEAK))
            print(f"{label:>18} {str(dtype)[6:]:>8} ms: " + ", ".join(
                f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
            if fp32 and b >= 8:  # the tensor cores no slower than the FMA kernel forced
                assert ms["fused 2+3"] <= ms["fma"], (label, ms)
            if b == 300:
                at300[dtype] = ms
    # fp32 C3 = 36 (not whole n8 tiles) takes the FMA kernel, and is right
    odd = [(torch.randn(s, generator=g) * 0.1).cuda()
           for s in ((2, 5, 128), (24, 5, EF.K), (24,), (24,), (36, 24, EF.K), (36,), (36,))]
    shapes = [(2, 24, 32), (2, 36, 8), (2, 36, 8)]
    got = launched(lambda: EF._launch(*odd, out=nan_outputs(*shapes, dtype=torch.float32)),
                   (1, 0, 0))
    err = worst(rel_err(o, r) for o, r in zip(got, EF.enc23_plain(*odd)))
    print(f"fp32 C3 = 36: FMA kernel, rel err {err:.2e}")
    assert err <= FP32_TOL, f"fp32 C3 = 36 vs plain rel err {err:.3e}"
    bad = [v.bfloat16() for v in odd]
    before = counters()
    try:
        EF.fused_enc23_fwd(*bad)
    except ValueError as e:
        print(f"bf16 C3 = 36 refused: {e}")
    else:
        raise AssertionError("the bf16 kernel took C3 = 36, which is not whole n8 tiles")
    assert counters() == before, "a refused call launched the kernel"
    print("chained kernel launches in phase 3b (all, 3xTF32, of those at tile 16): "
          f"{tuple(n - b for n, b in zip(counters(), start))}")
    # where the tile rule switches: both tiles in turns around B * 8 = SMs
    for b in (16, 32, 48, 64):
        args = bench.make_inputs(b, dtype=torch.float32, device="cuda")
        ms = bench.ms_in_turns({t: lambda t=t: EF._launch(*args, tile=t) for t in (16, 32)})
        print(f"fp32 tiles at B={b}: 16 {ms[16]:.4f} ms, 32 {ms[32]:.4f} ms; the rule takes "
              f"{EF._tf32_tile(b, 4096, sms)}", flush=True)
    return max_abs, at300


def phase_tool():
    """The A/B tool at its defaults (batch 300, bf16), then in fp32 (the 3xTF32 route),
    the path of the chained kernel. Returns its results by dtype and the launches of both
    kernels in it."""
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
    from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench

    K.launches = K.launches_mma = K.launches_tf32 = 0
    EF.launches = EF.launches_tf32 = EF.launches_tile16 = 0
    res = {"bfloat16": bench.main([])}
    tf32_before = EF.launches_tf32
    res["float32"] = bench.main(["--dtype", "float32"])
    torch.cuda.synchronize()
    counts = {"fused_conv1d_prelu": K.launches, "fused_enc23_fwd": EF.launches,
              "fused_enc23_fwd tf32": EF.launches_tf32}
    print(f"kernel launches in the A/B tool: {counts}, {K.launches_mma} of the per-layer "
          f"kernel's on the tensor cores")
    assert all(n > 0 for n in counts.values()), counts
    assert K.launches_mma == K.launches, "kernel x2 left the tensor cores"
    assert tf32_before == 0 and EF.launches_tile16 == 0, "bf16 or tile 16 at batch 300"
    assert (res["bfloat16"]["route"], res["float32"]["route"]) == ("mma", "tf32"), res
    assert all(e <= BF16_TOL for e in res["bfloat16"]["rel"].values()), res["bfloat16"]
    assert all(e <= FP32_TOL for e in res["float32"]["rel"].values()), res["float32"]
    return res, counts


def phase_tf32():
    """The port's TF32 policy: with cuDNN's TF32 switched on process-wide (PyTorch's
    default), a bare fp32 GDeconv1DBlock at G's second decoder shape and the convs of
    Conv1dPReLU's backward at enc3's shape still match float64 on the CPU. TF32 stays on
    for phase 4, whose card-vs-CPU check then rests on the ops' policy alone."""
    import torch
    from segan_pytorch_tpu_torch.models.modules import GDeconv1DBlock
    from segan_pytorch_tpu_torch.ops import conv as conv_ops
    from segan_pytorch_tpu_torch.ops.conv import conv1d_weight, conv_transpose1d
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator().manual_seed(SEED + 5)
    blk = GDeconv1DBlock(1024, 256, 31, stride=4, generator=gen)
    with torch.no_grad():
        blk.act.weight.uniform_(0.0, 0.3, generator=gen)
    x = torch.randn((8, 1024, 64), generator=gen)
    with torch.no_grad():
        got = blk.cuda()(x.cuda()).cpu()
        # the same with the policy bypassed: what the check would see without it
        policy = conv_ops.full_precision
        conv_ops.full_precision = lambda dtype: contextlib.nullcontext()
        try:
            bypassed = blk(x.cuda()).cpu()
        finally:
            conv_ops.full_precision = policy
        want = blk.cpu().double()(x.double())
    e_dec, e_bypassed = rel_err(got, want), rel_err(bypassed, want)
    # Conv1dPReLU's backward on the card vs its convs in float64, from the card's own
    # pre (a pre within rounding of 0 may take the other PReLU branch in float64)
    x = torch.randn((8, 128, 1053), generator=gen)
    w = torch.randn((256, 128, 31), generator=gen) / (128 * 31) ** 0.5
    a = torch.rand((256,), generator=gen) * 0.3
    gy, gpre = (torch.randn((8, 256, 256), generator=gen) for _ in range(2))
    xc, wc, ac = (v.cuda().requires_grad_() for v in (x, w, a))
    y, pre = K.conv1d_prelu(xc, wc, None, ac, 4)
    torch.autograd.backward([y, pre], [gy.cuda(), gpre.cuda()])
    pre64 = pre.detach().cpu().double()
    dpre = torch.where(pre64 > 0, gy.double(), gy.double() * a.double().view(1, -1, 1))
    dpre = dpre + gpre.double()
    dx = conv_transpose1d(dpre, w.double(), stride=4)
    dx = torch.nn.functional.pad(dx, (0, x.shape[2] - dx.shape[2]))
    dw = conv1d_weight(x.double(), w.shape, dpre, stride=4)
    e_dx, e_dw = rel_err(xc.grad.cpu(), dx), rel_err(wc.grad.cpu(), dw)
    print(f"TF32 on process-wide: fp32 GDeconv1DBlock (8, 1024, 64) -> 256 vs float64 rel "
          f"err {e_dec:.3e} ({e_bypassed:.3e} with the ops' policy bypassed); "
          f"Conv1dPReLU backward dx {e_dx:.3e}, dw {e_dw:.3e}")
    assert worst([e_dec, e_dx, e_dw]) <= FP32_TOL, (e_dec, e_dx, e_dw)


def _write_wavs(wav_dir: Path):
    """8 int16 16 kHz wavs of 0.5-6 s: 1-chunk (<= 16384 samples) and multi-chunk."""
    from scipy.io import wavfile

    rng = np.random.RandomState(SEED)
    lengths = [8000, 14000, 16384, 27000, 40000, 53100, 74000, 96000]
    for i, n in enumerate(lengths):
        t = np.arange(n) / SR
        sig = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t) + 0.05 * rng.randn(n)
        wavfile.write(str(wav_dir / f"utt{i}.wav"), SR,
                      np.clip(sig * 32767, -32768, 32767).astype(np.int16))
    return lengths


def phase_slice(work: Path):
    """The port's main path at full SEGAN+ width. Returns the kernel launches it made."""
    import torch
    from segan_pytorch_tpu_torch import clean
    from segan_pytorch_tpu_torch.data.wav_io import read_wav_raw
    from segan_pytorch_tpu_torch.models.generator import build_generator
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import ms_in_turns
    from segan_pytorch_tpu_torch.utils.checkpoint import save_generator
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts

    cfg = SEGANConfig(no_bias=True, save_path=str(work))
    gen = torch.Generator().manual_seed(SEED)
    G = build_generator(cfg, gen)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("act.weight"):  # a fresh G has every slope at 0 (a ReLU)
                p.uniform_(0.0, 0.3, generator=gen)
    n_params = sum(p.numel() for p in G.parameters())
    ckpt = work / "segan+_generator.ckpt"
    save_generator(G, str(ckpt))
    opts_file = dump_train_opts(cfg, str(work))
    print(f"G: {n_params} parameters, checkpoint {ckpt.stat().st_size / 2**20:.1f} MiB")
    wav_dir = work / "noisy"
    wav_dir.mkdir()
    lengths = _write_wavs(wav_dir)
    audio_s = sum(lengths) / SR
    chunks = [-(-n // cfg.slice_size) for n in lengths]
    print(f"wavs: {len(lengths)}, {audio_s:.2f} s of audio, chunks per wav {chunks}")

    def run_clean(opts, b, out_dir):
        out_dir.mkdir()
        args = clean.build_parser().parse_args([
            "--g_pretrained_ckpt", str(ckpt), "--cfg_file", opts,
            "--test_files", str(wav_dir), "--synthesis_path", str(out_dir),
            "--seed", str(SEED), "--batch_utts", str(b), "--device", "cuda"])
        t0 = time.perf_counter()
        clean.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ys = []
        for i, n in enumerate(lengths):
            path = out_dir / f"utt{i}.wav"
            assert path.exists(), f"missing output {path}"
            _, y = read_wav_raw(str(path))
            assert y.shape == (n,), f"{path}: {y.shape} != ({n},)"
            assert np.isfinite(y).all(), f"{path}: non-finite samples"
            ys.append(y)
        return ys, wall

    # the main path: clean.py in fp32 (3xTF32 on the tensor cores), then in bf16
    cfg_bf16 = SEGANConfig(no_bias=True, compute_dtype="bfloat16", save_path=str(work))
    opts_bf16 = dump_train_opts(cfg_bf16, str(work / "bf16"))
    outs = {}
    K.launches = K.launches_mma = K.launches_tf32 = 0
    n_forwards = 0
    for b in (1, 4):
        outs[b], wall = run_clean(opts_file, b, work / f"synth_b{b}")
        n_forwards += -(-len(lengths) // b)
        print(f"clean.py --batch_utts {b}: {audio_s / wall:.2f} s of audio per wall second "
              f"({audio_s:.2f} s in {wall:.3f} s, model load included)")
    fp32_launches = K.launches
    assert fp32_launches >= 5 * n_forwards and fp32_launches % 5 == 0, (
        f"{fp32_launches} launches for {n_forwards} fp32 G forwards")
    assert K.launches_tf32 == K.launches_mma == fp32_launches, (
        f"{fp32_launches} fp32 launches, {K.launches_tf32} on the tensor cores")
    y_bf, wall = run_clean(opts_bf16, 4, work / "synth_bf16")
    n_bf16 = -(-len(lengths) // 4)
    launches, launches_mma, launches_tf32 = K.launches, K.launches_mma, K.launches_tf32
    print(f"clean.py bf16 --batch_utts 4: {audio_s / wall:.2f} s of audio per wall second")
    print(f"kernel launches on the main path: {launches} ({launches_mma} on the tensor "
          f"cores, {launches_tf32} of them in fp32) for {n_forwards} fp32 and {n_bf16} bf16 "
          f"G forwards")
    assert launches_tf32 == fp32_launches, (launches_tf32, fp32_launches)
    assert launches_mma - launches_tf32 == 5 * n_bf16 == launches - fp32_launches, (
        launches, launches_mma, launches_tf32)
    for y1, y4, yb in zip(outs[1], outs[4], y_bf):
        e = float(np.abs(y1 - y4).max() / np.abs(y1).max())
        assert e <= FP32_TOL, f"batched vs sequential rel err {e:.3e}"
    e_wav_bf = worst(np.abs(yb - y4).max() / np.abs(y4).max() for y4, yb in zip(outs[4], y_bf))
    print(f"clean.py bf16 vs fp32 wavs: rel err {e_wav_bf:.3e}")

    # the card vs a CPU copy of the same model (plain ops), same z; the device memory of
    # the split weights that the first fp32 forward caches
    gpu = SEGAN(cfg, device="cuda", seed=SEED)
    gpu.g_load_pretrained(str(ckpt))
    cpu = SEGAN(cfg, device="cpu", seed=SEED)
    cpu.g_load_pretrained(str(ckpt))
    wav = np.random.RandomState(SEED + 1).randn(lengths[3]).astype(np.float32) * 0.3
    z = np.random.RandomState(SEED + 2).randn(16, cfg.z_dim).astype(np.float32)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    y_gpu, gc_gpu = gpu.generate(wav, z=z)
    torch.cuda.synchronize()
    cached = torch.cuda.memory_allocated() - mem0
    ours = {id(p) for p in gpu.G.parameters()}
    want = sum(2 * 4 * w.shape[0] * w.shape[1] * K.KP  # (big, small), 32 taps, fp32
               for w in K._padded.keys() if id(w) in ours)
    print(f"device memory held after the first fp32 forward: {cached / 2**20:.1f} MiB "
          f"(the split encoder weights: {want / 2**20:.1f} MiB expected)")
    y_cpu, gc_cpu = cpu.generate(wav, z=z)
    e_wav = float(np.abs(y_gpu - y_cpu).max() / np.abs(y_cpu).max())
    e_gc = float(np.abs(gc_gpu - gc_cpu).max() / np.abs(gc_cpu).max())
    print(f"card vs CPU generate(): rel err {e_wav:.3e} (wav), {e_gc:.3e} (g_c)")
    assert e_wav <= SLICE_TOL and e_gc <= SLICE_TOL, (e_wav, e_gc)
    del cpu

    x64 = torch.from_numpy(np.random.RandomState(SEED + 3).randn(
        64, cfg.slice_size, 1).astype(np.float32) * 0.3).cuda()
    z64 = gpu.G.sample_z(tuple(x64.shape), torch.Generator().manual_seed(SEED)).cuda()

    def fma_route_forward(engine):
        route = K._route
        K._route = lambda *shape: "fma"
        try:
            return engine.infer_G(x64, z64)
        finally:
            K._route = route

    before = K.launches_tf32
    y32 = gpu.infer_G(x64, z64)
    assert K.launches_tf32 - before == 5, f"{K.launches_tf32 - before} fp32 MMA launches"
    before = K.launches_mma
    e32_fma = rel_err(fma_route_forward(gpu), y32)
    assert K.launches_mma == before and e32_fma <= SLICE_TOL, e32_fma
    t = ms_in_turns({"tc": lambda: gpu.infer_G(x64, z64),
                     "fma": lambda: fma_route_forward(gpu)}, reps=10, warmup=2)
    print(f"G forward at batch 64 (fp32): {t['tc']:.3f} ms, {64e3 / t['tc']:.1f} chunks/s "
          f"(3xTF32 tensor cores); {t['fma']:.3f} ms, {64e3 / t['fma']:.1f} chunks/s (FMA "
          f"route, same call); tensor cores vs FMA route rel err {e32_fma:.3e}")
    bf = SEGAN(cfg_bf16, generator=gpu.G, device="cuda")
    before = K.launches_mma
    y_bf = bf.infer_G(x64, z64)
    assert K.launches_mma - before == 5, f"{K.launches_mma - before} MMA launches, not 5"
    e_bf = rel_err(y_bf, y32)
    # a sanity bound: bf16 rounds every one of the 10 layers' inputs and outputs
    assert torch.isfinite(y_bf).all() and e_bf <= 0.1, e_bf
    before = K.launches_mma
    e_fma = rel_err(fma_route_forward(bf), y32)
    assert K.launches_mma == before and e_fma <= 0.1, e_fma
    t = ms_in_turns({"mma": lambda: bf.infer_G(x64, z64),
                     "fma": lambda: fma_route_forward(bf)}, reps=10, warmup=2)
    print(f"G forward at batch 64 (bf16): {t['mma']:.3f} ms, {64e3 / t['mma']:.1f} chunks/s "
          f"(tensor cores); {t['fma']:.3f} ms, {64e3 / t['fma']:.1f} chunks/s (FMA route, "
          f"same call); rel err vs fp32 {e_bf:.3e} (FMA route {e_fma:.3e})")
    return launches, launches_mma, launches_tf32


# G's step gradients on the card vs float64 with D' = D: a PReLU kink taken the other way
# moves them by some 1e-3, so ten times that
KINK_TOL = 5e-2
# D's conv biases feed a BatchNorm, which takes the per-channel mean out: their true
# gradient is 0 and what autograd returns for them is rounding noise
BIAS_BEFORE_BN = tuple(f"enc_blocks.{i}.conv.bias" for i in range(5))


def phase_train_kernel():
    """5a: Conv1dPReLU's backward vs autograd of the plain version, on the card, and the
    kernel's cached weights across optimizer steps."""
    import torch
    from segan_pytorch_tpu_torch.models.segan import build_optimizer
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    torch.backends.cudnn.allow_tf32 = False  # the plain version's backward convs: fp32
    g = torch.Generator().manual_seed(SEED + 6)
    T, Kw, S = 16384, 31, 4
    chans = [1, 64, 128, 256, 512, 1024]
    print(f"{'layer':>12} {'dtype':>8} | {'dx':>9} {'dw':>9} {'db':>9} {'da':>9} | gy zeroed")
    for b, i in [(8, i) for i in range(5)] + [(300, 1)]:
        t_out = T // S ** (i + 1)
        cin, cout = chans[i], chans[i + 1]
        x = torch.randn((b, cin, S * t_out + Kw - 2), generator=g)
        w = torch.randn((cout, cin, Kw), generator=g) / (cin * Kw) ** 0.5
        bias = torch.randn((cout,), generator=g) * 0.1
        a = torch.rand((cout,), generator=g) * 0.3
        gy, gpre = (torch.randn((b, cout, t_out), generator=g) for _ in range(2))
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            leaves = [v.to(dtype).cuda().requires_grad_() for v in (x, w, bias, a)]
            refs = [v.detach().clone().requires_grad_() for v in leaves]
            before = (K.launches_mma, K.launches_tf32)
            y, pre = K.conv1d_prelu(*leaves, S)
            moved = (K.launches_mma - before[0], K.launches_tf32 - before[1])
            assert moved == (1, int(dtype == torch.float32)), f"routes moved by {moved}"
            y_r, pre_r = K.conv1d_prelu_plain(*refs, S)
            p = pre_r.detach().float().abs()
            near = p <= tol * p.max()
            gy_d = torch.where(near, 0.0, gy.cuda()).to(dtype)
            gpre_d = gpre.cuda().to(dtype)
            torch.autograd.backward([y, pre], [gy_d, gpre_d])
            torch.autograd.backward([y_r, pre_r], [gy_d, gpre_d])
            errs = [rel_err(v.grad, r.grad) for v, r in zip(leaves, refs)]
            label = f"B={b} enc{i + 1}"
            print(f"{label:>12} {str(dtype)[6:]:>8} | " + " ".join(f"{e:9.2e}" for e in errs)
                  + f" | {float(near.float().mean()):.2%}", flush=True)
            assert worst(errs) <= tol, f"{label} {dtype}: backward vs plain {errs} > {tol}"
            del leaves, refs, y, pre, y_r, pre_r
    # the cached padded (fp32: split) weights after an in-place optimizer step
    x = torch.randn((8, 128, 1053), generator=g).cuda()
    a = (torch.rand((256,), generator=g) * 0.3).cuda()
    w0 = torch.randn((256, 128, Kw), generator=g) / (128 * Kw) ** 0.5
    shape = (8, 256, 256)
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        xd, ad = x.to(dtype), a.to(dtype)
        for opt in ("rmsprop", "adam"):
            w = torch.nn.Parameter(w0.to(dtype).cuda())
            o = build_optimizer(opt, 1e-2, [w])
            y0, _ = K.fused_conv1d_prelu(xd, w, None, ad, S)  # caches w's padded copy
            w.grad = torch.randn(w.shape, generator=g).to(dtype).cuda()
            o.step()
            with torch.no_grad():
                y1, pre1 = K._launch(xd, w, None, ad, S, 256,
                                     out=nan_outputs(shape, shape, dtype=dtype))
                y_ref, pre_ref = K.conv1d_prelu_plain(xd, w, None, ad, S)
            e = worst([rel_err(y1, y_ref), rel_err(pre1, pre_ref)])
            moved = rel_err(y0, y_ref)
            print(f"after one {opt} step ({str(dtype)[6:]}): kernel vs plain with the new w "
                  f"rel err {e:.2e}; the old output differs by {moved:.2e}")
            assert e <= tol and moved > 10 * tol, (opt, dtype, e, moved)
    w = torch.nn.Parameter(w0.cuda())
    version = w._version
    w.grad = torch.ones_like(w)
    torch.optim.Adam([w], lr=1e-3, fused=True).step()
    print(f"for the record: fused Adam bumps the weight's version counter: "
          f"{w._version > version} (the port never uses fused=True)")


def _train_models(cfg, seed):
    """A seeded SEGAN+ G and D with every PReLU slope drawn from U(0, 0.3)."""
    import torch
    from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
    from segan_pytorch_tpu_torch.models.generator import build_generator

    gen = torch.Generator().manual_seed(seed)
    G, D = build_generator(cfg, gen), build_discriminator(cfg, gen)
    with torch.no_grad():
        for name, p in list(G.named_parameters()) + list(D.named_parameters()):
            if name.endswith("act.weight"):
                p.uniform_(0.0, 0.3, generator=gen)
    return G, D


def _train_batch(b, t, seed):
    """bench.py's synthetic batch: clean ~ N(0, 0.1^2), noisy = clean + N(0, 0.02^2)."""
    import torch

    rng = np.random.RandomState(seed)
    clean = (rng.randn(b, t, 1) * 0.1).astype(np.float32)
    noisy = clean + (rng.randn(b, t, 1) * 0.02).astype(np.float32)
    return torch.from_numpy(clean), torch.from_numpy(noisy)


def phase_train_parity():
    """5b: one full-width fp32 step at B = 4 on the card and on a CPU copy, both held
    against the same step in float64 on the CPU; then G's backward alone, and a step
    with D's learning rate 0.

    The step is ill-conditioned in places, so its gradients are held to the CPU's own
    fp32 error, up to a factor: D's per-channel gradients (BatchNorm's scales, shifts,
    PReLU slopes) sum B x T terms that nearly cancel (the CPU's fp32 gradients of D's
    first block read ~2e-3 off float64). G's gradient goes through D after an RMSprop step that moves
    each weight by ~10 lr sign(g), so a last-bit difference in a gradient near 0 moves a
    weight of D' by 20 lr (G's gradients then read several 1e-2 off float64 on the card,
    printed, not held); and through PReLU kinks that a BatchNorm output within 1e-6 of 0
    may take either way, in D' as in D, each of which moves them by some 1e-3. So: the
    card's losses and Genh <= 1e-3 relative (g_adv, which goes through D' as well, in the
    second step below); D's gradients, all tensors together, within max(1e-3, 4 x the
    CPU fp32 ones' error) in L2 and each within max(1e-2, 4 x the CPU's);
    G's backward from a fixed upstream gradient, each tensor <= 1e-3; and in a second
    step with D's learning rate 0 (D' = D, no sign flips) g_adv <= 1e-3 and G's step
    gradients, all tensors together, <= KINK_TOL."""
    import copy
    import dataclasses
    import torch
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops import conv as conv_ops
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    cfg = SEGANConfig(no_bias=True)
    G, D = _train_models(cfg, SEED + 7)
    clean, noisy = _train_batch(4, cfg.slice_size, SEED + 8)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    z = torch.randn((4, 16, cfg.z_dim), generator=torch.Generator().manual_seed(SEED + 9))
    phase = D.sample_phase(torch.Generator().manual_seed(SEED + 10), passes=3)

    def step(device, dtype=torch.float32, c=cfg):
        """One step of copies of G and D: (losses, Genh, gradients) on the CPU in
        float64. A float64 step runs on float64 copies of the fp32 weights (the engine's
        compute dtype set to float64); the CPU's convs are torch's own (oneDNN off)."""
        seg = SEGAN(c, generator=copy.deepcopy(G), discriminator=copy.deepcopy(D),
                    device=device)
        seg.compute_dtype = dtype
        with torch.backends.mkldnn.flags(enabled=False):
            m, genh, _ = seg.train_step(clean, noisy, mask, 100.0, z=z, phase=phase)
        grads = {f"{side}.{n}": p.grad.cpu().double() for side in ("G", "D")
                 for n, p in getattr(seg, side).named_parameters()
                 if not (side == "D" and n in BIAS_BEFORE_BN)}
        bias_noise = worst(float(blk.conv.bias.grad.norm() / blk.norm.bias.grad.norm())
                           for blk in seg.D.enc_blocks)
        return ({k: float(v) for k, v in m.items()}, genh.cpu().double(), grads,
                bias_noise)

    def g_backward(device, dtype=torch.float32):
        """G's gradients from a fixed upstream gradient of Genh, as the CPU's float64."""
        g = copy.deepcopy(G).to(device, dtype).train()
        with conv_ops.full_precision(dtype), torch.backends.mkldnn.flags(enabled=False):
            y = g(noisy.to(device, dtype), z.to(device, dtype))
            y.backward(d_genh.to(device, dtype))
        return {f"G.{n}": p.grad.cpu().double() for n, p in g.named_parameters()}

    def rel(a, ref):
        return float((a - ref).norm() / ref.norm().clamp_min(1e-300))

    def rel_all(a, ref, keys):
        num = sum(float((a[k] - ref[k]).norm()) ** 2 for k in keys)
        return (num / sum(float(ref[k].norm()) ** 2 for k in keys)) ** 0.5

    def show(e_card, e_cpu, keys):
        top = sorted(keys, key=lambda k: -e_card[k])[:3]
        return ", ".join(f"{k} ({e_card[k]:.1e}, {e_cpu[k]:.1e})" for k in top)

    before = K.launches_tf32
    t0 = time.perf_counter()
    card = step("cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    assert K.launches_tf32 - before == 5, f"{K.launches_tf32 - before} 3xTF32 launches"
    t0 = time.perf_counter()
    cpu = step("cpu")
    t_cpu = time.perf_counter() - t0
    ref = step("cpu", torch.float64)
    losses = {}
    for name, a in (("card", card), ("CPU", cpu)):
        losses[name] = {k: abs(a[0][k] - ref[0][k]) / abs(ref[0][k]) for k in ref[0]}
        losses[name]["Genh"] = rel_err(a[1], ref[1])
    e_card = {k: rel(v, ref[2][k]) for k, v in card[2].items()}
    e_cpu = {k: rel(v, ref[2][k]) for k, v in cpu[2].items()}
    d_keys = [k for k in ref[2] if k.startswith("D.")]
    g_keys = [k for k in ref[2] if k.startswith("G.")]
    d_all = {n: rel_all(a[2], ref[2], d_keys) for n, a in (("card", card), ("CPU", cpu))}
    g_all = {n: rel_all(a[2], ref[2], g_keys) for n, a in (("card", card), ("CPU", cpu))}
    d_genh = torch.randn(clean.shape, generator=torch.Generator().manual_seed(SEED + 14)) * 1e-3
    before = K.launches_tf32
    gb = {"card": g_backward("cuda"), "CPU": g_backward("cpu")}
    assert K.launches_tf32 - before == 5, f"{K.launches_tf32 - before} 3xTF32 launches"
    gb_ref = g_backward("cpu", torch.float64)
    gb_err = {n: {k: rel(v, gb_ref[k]) for k, v in a.items()} for n, a in gb.items()}
    frozen = dataclasses.replace(cfg, d_lr=0.0)
    ref0 = step("cpu", torch.float64, frozen)
    card0 = step("cuda", c=frozen)
    g0_all = {n: rel_all(a[2], ref0[2], g_keys)
              for n, a in (("card", card0), ("CPU", step("cpu", c=frozen)))}
    g_adv0 = abs(card0[0]["g_adv"] - ref0[0]["g_adv"]) / abs(ref0[0]["g_adv"])
    print(f"train step, B=4 fp32, one row masked, vs float64 on the CPU (card {t_card:.2f} s,"
          f" CPU {t_cpu:.2f} s): losses and Genh card " + ", ".join(
              f"{k} {v:.1e}" for k, v in losses["card"].items()) + "; CPU " + ", ".join(
              f"{k} {v:.1e}" for k, v in losses["CPU"].items())
          + f"\n  D's gradients, all {len(d_keys)} tensors: card {d_all['card']:.1e}, CPU "
          f"{d_all['CPU']:.1e}; worst (card, CPU) {show(e_card, e_cpu, d_keys)}"
          f"\n  G's gradients, all {len(g_keys)} tensors: card {g_all['card']:.1e}, CPU "
          f"{g_all['CPU']:.1e}; worst (card, CPU) {show(e_card, e_cpu, g_keys)}"
          f"\n  G's backward from a fixed gradient of Genh: worst (card, CPU) "
          f"{show(gb_err['card'], gb_err['CPU'], list(gb_ref))}"
          f"\n  with d_lr = 0 (D' = D): card g_adv {g_adv0:.1e}; G's gradients, all "
          f"tensors: card {g0_all['card']:.1e}, CPU {g0_all['CPU']:.1e}"
          f"\n  D's BN-fed conv bias gradients / BN bias gradients: card {card[3]:.1e}, "
          f"float64 {ref[3]:.1e}", flush=True)
    # g_adv goes through D' too: held in the step with D' = D
    assert worst(v for k, v in losses["card"].items() if k != "g_adv") <= SLICE_TOL, losses
    assert g_adv0 <= SLICE_TOL, g_adv0
    assert d_all["card"] <= max(SLICE_TOL, 4 * d_all["CPU"]), d_all
    bad = {k: (e_card[k], e_cpu[k]) for k in d_keys
           if not e_card[k] <= max(10 * SLICE_TOL, 4 * e_cpu[k])}
    assert not bad, bad
    assert worst(gb_err["card"].values()) <= SLICE_TOL, gb_err["card"]
    assert g0_all["card"] <= KINK_TOL, g0_all
    assert card[3] <= 1e-3, card[3]


def phase_train_b300():
    """5c: the step at full width and batch 300 in fp32 and bf16, timed by CUDA events;
    then the bench entry point. Returns the kernel's launches per step and the slices/s
    of the timed steps and of the bench entry, by dtype."""
    import statistics
    import torch
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    B, n_steps = 300, 10
    per_step = set()
    rates = {}
    for dtype in ("float32", "bfloat16"):
        cfg = SEGANConfig(no_bias=True, compute_dtype=dtype, batch_size=B)
        G, D = _train_models(cfg, SEED + 11)
        seg = SEGAN(cfg, generator=G, discriminator=D, device="cuda")
        clean, noisy = (v.cuda() for v in _train_batch(B, cfg.slice_size, SEED + 12))
        mask = torch.ones((B,), device="cuda")
        marks = {"G forward": [], "D update": [], "G update": []}

        def timed(fn, name):
            def run(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                marks[name].append((start, end))
                return out
            return run

        seg._g_forward = timed(seg._g_forward, "G forward")
        seg._d_update = timed(seg._d_update, "D update")
        seg._g_update = timed(seg._g_update, "G update")
        for _ in range(3):
            metrics, _, _ = seg.train_step(clean, noisy, mask, 100.0)
        float(metrics["d_real"])
        for v in marks.values():
            v.clear()
        torch.cuda.reset_peak_memory_stats()
        steps, losses = [], []
        K.launches = K.launches_mma = K.launches_tf32 = 0
        for _ in range(n_steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics, _, _ = seg.train_step(clean, noisy, mask, 100.0)
            end.record()
            steps.append((start, end))
            losses.append(torch.stack(list(metrics.values())))
        torch.cuda.synchronize()
        launches, mma, tf32 = K.launches, K.launches_mma, K.launches_tf32
        losses = torch.stack(losses).cpu()
        assert torch.isfinite(losses).all(), losses
        assert launches == mma == 5 * n_steps, (launches, mma)
        assert tf32 == (launches if dtype == "float32" else 0), (tf32, launches)
        per_step.add(launches // n_steps)
        ms = [s.elapsed_time(e) for s, e in steps]
        total = steps[0][0].elapsed_time(steps[-1][1])
        split = {k: statistics.median(s.elapsed_time(e) for s, e in v)
                 for k, v in marks.items()}
        rates[dtype] = B * n_steps / total * 1e3
        print(f"train step B={B} {dtype}: {B * n_steps / total * 1e3:.2f} slices/s "
              f"({total:.2f} ms for {n_steps} steps, median {statistics.median(ms):.3f} "
              f"ms/step); median split " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
              + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"fused_conv1d_prelu launches {launches} ({mma} on the tensor cores, {tf32} "
              f"3xTF32); last losses " + ", ".join(
                  f"{k} {float(v):.4f}" for k, v in zip(metrics, losses[-1])), flush=True)
        del seg, G, D, clean, noisy, metrics
        torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        out = subprocess.run(
            [sys.executable, "-m", "segan_pytorch_tpu_torch.bench", "--steps", "5",
             "--warmup", "2", "--compute_dtype", dtype],
            cwd=str(ROOT), capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"bench ({dtype}): {json.dumps(res)}", flush=True)
        assert (res["metric"], res["batch"], res["compute_dtype"]) == (
            "train_slices_per_sec_per_chip", B, dtype) and res["value"] > 0, res
        rates[f"bench {dtype}"] = res["value"]
    assert len(per_step) == 1, per_step
    return per_step.pop(), rates


def _write_corpus(root: Path, n_files: int, seconds: float, seed: int):
    """Paired int16 16 kHz wavs: clean a harmonic tone complex (f0 100-250 Hz, five
    harmonics, a syllable-rate envelope), noisy the clean one plus white noise at 0-15 dB
    SNR. Returns (clean dir, noisy dir)."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    dirs = []
    for sub in ("clean", "noisy"):
        (root / sub).mkdir(parents=True)
        dirs.append(str(root / sub))
    for i in range(n_files):
        f0 = rng.uniform(100, 250)
        clean = sum(rng.uniform(0.2, 1.0) / h * np.sin(2 * np.pi * h * f0 * t
                                                       + rng.uniform(0, 2 * np.pi))
                    for h in range(1, 6))
        clean *= 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        clean *= 0.3 / np.abs(clean).max()
        noise = rng.randn(n) * np.sqrt(np.mean(clean ** 2) / 10 ** (rng.uniform(0, 15) / 10))
        wavfile.write(f"{dirs[0]}/u{i:02d}.wav", SR, (clean * 32767).astype(np.int16))
        wavfile.write(f"{dirs[1]}/u{i:02d}.wav", SR,
                      np.clip((clean + noise) * 32767, -32768, 32767).astype(np.int16))
    return dirs


def _pesq_backend() -> str:
    """The backend that metrics.pesq.PESQ takes here, in its order."""
    import importlib.util
    import os
    import shutil
    from segan_pytorch_tpu_torch.metrics import pesq_native

    mode = os.environ.get("SEGAN_TPU_PESQ", "auto")
    if mode not in ("approx", "native"):
        if shutil.which("pesqmain"):
            return "pesqmain (ITU binary)"
        if importlib.util.find_spec("pesq") is not None:
            return "the python pesq package"
        if mode == "strict":
            return "none (PESQ reads -1)"
    if mode != "approx" and pesq_native.get_lib() is not None:
        return "native/pesq862.cpp (P.862 pipeline, not ITU-certified)"
    return "the spectral approximation (metrics/perceptual.py)"


RUN_LINES = ("(Iter", "[*]", "[!]", "[data]", "Val ", "Time to process", "STOPPING")
LOG_RE = re.compile(r"^\(Iter (\d+)\) Batch (\d+)/(\d+) \(Epoch (\d+)\) d_real:(\S+), "
                    r"d_fake:(\S+), g_adv:(\S+), g_l1:(\S+) l1_w", re.M)


def phase_train_run(work: Path, rates):
    """6: the training run at full SEGAN+ width on the card: `python -m
    segan_pytorch_tpu_torch.train`'s main, batch 300, fp32, one epoch with a validation
    set, then --resume to epoch 2; then the port's clean CLI with the last EOE G. Returns
    the kernel's launches over the two runs."""
    import torch
    from segan_pytorch_tpu_torch import clean as clean_cli
    from segan_pytorch_tpu_torch import train as train_cli
    from segan_pytorch_tpu_torch.data import loader as loader_mod
    from segan_pytorch_tpu_torch.data.wav_io import read_wav_raw
    from segan_pytorch_tpu_torch.models.generator import build_generator
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.utils.checkpoint import save_generator
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig, load_train_opts

    t0 = time.perf_counter()
    # 16 x 20 s: 38 slices each at stride 0.5, 608 in all: batches of 300, 300 and 8;
    # validation 2 x 4 s: 6 slices each, one batch of 300 with 12 valid rows
    train_dirs = _write_corpus(work / "train", 16, 20.0, SEED + 20)
    valid_dirs = _write_corpus(work / "valid", 2, 4.0, SEED + 21)
    print(f"corpus: 16 x 20 s training pairs, 2 x 4 s validation pairs, written in "
          f"{time.perf_counter() - t0:.2f} s; PESQ backend: {_pesq_backend()}", flush=True)
    # G starts from a checkpoint (--g_pretrained_ckpt) with a quiet output layer (its
    # weights x 0.01, its bias 0) and learns at 1/100 of SEGAN+'s rate (--g_lr 5e-7). A
    # random G's output carries a DC offset (the last deconv keeps a bias under
    # --no_bias, as upstream's does) that de-emphasis multiplies by 20, and RMSprop's
    # first steps move each weight by ~10 lr whatever its gradient: either puts SSNR near
    # its floor of -10 dB and COVL + PESQ + SSNR below the loop's first best of 0 (-5.6
    # on these wavs), so no best-val checkpoint would be written; the quiet G reads 2.5
    G = build_generator(SEGANConfig(no_bias=True), torch.Generator().manual_seed(SEED + 23))
    with torch.no_grad():
        G.dec_blocks[-1].deconv.weight.mul_(0.01)
        G.dec_blocks[-1].deconv.bias.zero_()
    save_generator(G, str(work / "g_start.ckpt"))
    del G
    save = work / "ckpt"
    argv = ["--save_path", str(save), "--clean_trainset", train_dirs[0],
            "--noisy_trainset", train_dirs[1], "--clean_valset", valid_dirs[0],
            "--noisy_valset", valid_dirs[1], "--cache_dir", str(work / "cache"),
            "--batch_size", "300", "--no_bias", "--save_freq", "1", "--seed", str(SEED),
            "--g_lr", "5e-7", "--device", "cuda"]

    # what the loop spends its time on, read by wrapping the engine's methods
    marks = {}
    infer, evaluate, save_ckpt, prefetch = (SEGAN.infer_G, SEGAN.evaluate, SEGAN.save,
                                            loader_mod.device_prefetch)

    def counted_infer(self, *a, **k):
        marks["forwards"] += 1
        return infer(self, *a, **k)

    def timed_evaluate(self, *a, **k):
        marks["loop_end"] = marks.get("loop_end") or time.perf_counter()
        start = time.perf_counter()
        try:
            return evaluate(self, *a, **k)
        finally:
            marks["eval"] += time.perf_counter() - start

    def timed_save(self, *a, **k):
        start = time.perf_counter()
        try:
            return save_ckpt(self, *a, **k)
        finally:
            marks["save"] += time.perf_counter() - start

    def timed_prefetch(iterator, device, size=2):
        stream = prefetch(iterator, device, size)
        while True:
            start = time.perf_counter()
            marks["loop_start"] = marks.get("loop_start") or start
            batch = next(stream, None)
            if batch is None:
                return
            marks["wait"].append(time.perf_counter() - start)
            yield batch

    runs = []
    SEGAN.infer_G, SEGAN.evaluate, SEGAN.save = counted_infer, timed_evaluate, timed_save
    loader_mod.device_prefetch = timed_prefetch
    try:
        K.launches = K.launches_mma = K.launches_tf32 = 0
        for extra in (["--epoch", "1", "--g_pretrained_ckpt", str(work / "g_start.ckpt")],
                      ["--epoch", "2", "--resume"]):
            marks.clear()
            marks.update(forwards=0, eval=0.0, save=0.0, wait=[])
            out = io.StringIO()
            start = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    seg = train_cli.main(argv + extra)
            finally:  # the run's own lines, without its train.opts dump
                print("\n".join(line for line in out.getvalue().splitlines()
                                if line.startswith(RUN_LINES)), flush=True)
            torch.cuda.synchronize()
            runs.append(dict(marks, wall=time.perf_counter() - start, out=out.getvalue(),
                             step=seg.step))
        launches, mma, tf32 = K.launches, K.launches_mma, K.launches_tf32
    finally:
        SEGAN.infer_G, SEGAN.evaluate, SEGAN.save = infer, evaluate, save_ckpt
        loader_mod.device_prefetch = prefetch
    del seg

    # the loop: resumed at step 3, iterations on from 4, finite losses
    assert "[*] Resumed from step 3" in runs[1]["out"], runs[1]["out"][-2000:]
    for run, epoch, first in ((runs[0], 1, 1), (runs[1], 2, 4)):
        logged = LOG_RE.findall(run["out"])
        iters = [int(m[0]) for m in logged]
        assert iters == [first, first + 1, first + 2], iters
        assert all(int(m[2]) == 3 and int(m[3]) == epoch for m in logged), logged
        losses = np.array([[float(v) for v in m[4:]] for m in logged])
        assert np.isfinite(losses).all(), losses
        run["losses"] = losses[-1]
    assert (runs[0]["step"], runs[1]["step"]) == (3, 6), [r["step"] for r in runs]
    steps = 6
    forwards = runs[0]["forwards"] + runs[1]["forwards"]
    # a G forward per log point (gen_train_samples) and one for evaluate, per run
    assert forwards == 8, forwards
    print(f"fused_conv1d_prelu launches over the two runs: {launches} ({mma} on the tensor "
          f"cores, {tf32} 3xTF32) for {steps} train steps and {forwards} G forwards")
    assert launches == mma == tf32 == 5 * (steps + forwards), (launches, mma, tf32)

    # the checkpoints: rotating EOE G and D, and the best-val ones, each index pointing at
    # payloads that exist, with the optimizer's state and the steps taken
    # each train() call starts from a best of 0 (as in JAX): a run saves a best-val G and
    # D when its val_obj is above 0
    val_objs = [json.loads(line)["value"] for line in
                (save / "train" / "scalars.jsonl").read_text().splitlines()
                if json.loads(line)["tag"] == "Genh-val_obj"]
    assert len(val_objs) == 2, val_objs
    want_best = [f"SEGAN-G-best_Generator-{i}.ckpt" for v, i in zip(val_objs, (4, 7))
                 if v > 0]
    indices = {}
    for prefix in ("EOE_G-", "EOE_D-", "SEGAN-G-", "SEGAN-D-"):
        path = save / f"{prefix}checkpoints"
        assert path.exists(), f"no index {path.name}: {sorted(os.listdir(save))}"
        indices[prefix] = json.loads(path.read_text())
        for name in indices[prefix]["latest"]:
            assert (save / f"weights_{name}").exists(), name
    assert indices["EOE_G-"]["latest"] == ["EOE_G-Generator-4.ckpt",
                                           "EOE_G-Generator-7.ckpt"], indices["EOE_G-"]
    assert indices["SEGAN-G-"]["latest"] == want_best, (val_objs, indices["SEGAN-G-"])
    last_g = save / "weights_EOE_G-Generator-7.ckpt"
    payload = torch.load(last_g, map_location="cpu", weights_only=True)
    assert payload["step"] == 6 and len(payload["optimizer"]["state"]) > 0, payload.keys()
    del payload
    print(f"checkpoints: EOE {indices['EOE_G-']['latest']}, best-val "
          f"{indices['SEGAN-G-']['latest']} (val_obj COVL + PESQ + SSNR of the two runs "
          + ", ".join(f"{v:.4f}" for v in val_objs) + f"); {last_g.stat().st_size / 2**20:.1f}"
          f" MiB per EOE G payload (weights + RMSprop state)")

    # after a resume the kernel runs on the loaded encoder weights: fill its weight cache
    # with a fresh G's, resume, and hold it against the plain version
    eng = SEGAN(load_train_opts(str(save / "train.opts")), device="cuda", seed=SEED)
    g = torch.Generator().manual_seed(SEED + 22)
    xs, before = [], []
    t_in = 4 * (16384 // 4) + 29
    for blk in eng.G.enc_blocks:
        w = blk.conv.weight
        xs.append(torch.randn((2, w.shape[1], t_in), generator=g).cuda())
        before.append(K.fused_conv1d_prelu(xs[-1], w, blk.conv.bias, blk.act.weight, 4)[1])
        t_in = (t_in - 29) // 4 + 29
    with contextlib.redirect_stdout(io.StringIO()):
        assert eng.resume(str(save)) == 6
    errs, moved = [], []
    with torch.no_grad():
        for x, blk, old in zip(xs, eng.G.enc_blocks, before):
            w, b, a = blk.conv.weight, blk.conv.bias, blk.act.weight
            t_out = K._check(x, w, b, a, 4)
            shape = (x.shape[0], w.shape[0], t_out)
            y, pre = K._launch(x, w, b, a, 4, t_out, out=nan_outputs(shape, shape,
                                                                      dtype=x.dtype))
            y_ref, pre_ref = K.conv1d_prelu_plain(x, w, b, a, 4)
            errs.append(worst([rel_err(y, y_ref), rel_err(pre, pre_ref)]))
            moved.append(rel_err(old, pre_ref))
    print("after resume: kernel vs plain on the loaded encoder weights, rel err "
          + ", ".join(f"{e:.1e}" for e in errs) + "; the fresh G's outputs differ by "
          + ", ".join(f"{m:.1e}" for m in moved))
    assert worst(errs) <= FP32_TOL and min(moved) > 10 * FP32_TOL, (errs, moved)
    del eng, xs, before

    # the port's clean CLI with the last EOE G
    out_dir = work / "enhanced"
    out_dir.mkdir()
    opts = clean_cli.build_parser().parse_args([
        "--g_pretrained_ckpt", str(last_g), "--cfg_file", str(save / "train.opts"),
        "--test_files", valid_dirs[1], "--synthesis_path", str(out_dir), "--seed",
        str(SEED), "--device", "cuda"])
    with contextlib.redirect_stdout(io.StringIO()):
        clean_cli.main(opts)
    for name in sorted(os.listdir(valid_dirs[1])):
        _, y = read_wav_raw(str(out_dir / name))
        assert y.shape == (64000,) and np.isfinite(y).all(), (name, y.shape)
    print(f"clean CLI with weights_EOE_G-Generator-7.ckpt: {len(os.listdir(out_dir))} "
          f"validation wavs enhanced")

    for i, run in enumerate(runs, 1):
        loop = run["loop_end"] - run["loop_start"]
        print(f"train run {i}: {run['wall']:.2f} s in main(), of which the batch loop "
              f"{loop:.3f} s (3 steps of 300, a log point each: losses read, weight norms, "
              f"20 sample wavs), evaluate {run['eval']:.3f} s, checkpoint saves "
              f"{run['save']:.3f} s on the calling thread; data wait per step "
              + ", ".join(f"{1e3 * w:.2f}" for w in run["wait"]) + " ms; last losses "
              + ", ".join(f"{v:.4f}" for v in run["losses"]), flush=True)
    loop = runs[1]["loop_end"] - runs[1]["loop_start"]
    print(f"training loop (run 2, warm): {900 / loop:.2f} slices/s over its 3 steps; the "
          f"bare fp32 step (5c) {rates['float32']:.2f}, the bench entry "
          f"{rates['bench float32']:.2f} slices/s", flush=True)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import segan_pytorch_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    phase_build()
    per_layer = phase_kernel()
    enc23_abs, enc23_ms = phase_enc23()
    tool, tool_launches = phase_tool()
    phase_tf32()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        launches, launches_mma, launches_tf32 = phase_slice(Path(work))
    phase_train_kernel()
    phase_train_parity()
    train_per_step, train_rates = phase_train_b300()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        train_run = phase_train_run(Path(work), train_rates)
    # the tool's shapes, batch 300 with biases; cuDNN's two convs and the FMA kernel
    # forced at batch 300 from phase 3b
    flops, nbytes = enc23_work(300, 4096, 64, 128, 256, True, 2)
    bf16, fp32 = (enc23_ms[torch.bfloat16], enc23_ms[torch.float32])
    measured = [
        dict(launches=launches, launches_mma=launches_mma, launches_tf32=launches_tf32,
             train_launches_per_step=train_per_step, train_run_launches=train_run,
             **per_layer),
        dict(launches=tool_launches["fused_enc23_fwd"],
             launches_tf32=tool_launches["fused_enc23_fwd tf32"],
             max_abs_err=enc23_abs[torch.bfloat16], ms=tool["bfloat16"]["ms"]["fused 2+3"],
             plain_ms=tool["bfloat16"]["ms"]["plain chain"],
             bound_ms=bound_ms(flops, nbytes, BF16_PEAK), bound_by="operations",
             library_ms=bf16["cuDNN x2"], fp32_max_abs_err=enc23_abs[torch.float32],
             fp32_ms=tool["float32"]["ms"]["fused 2+3"], fp32_fma_ms=fp32["fma"],
             fp32_plain_ms=tool["float32"]["ms"]["plain chain"],
             fp32_bound_ms=min(bound_ms(flops, 2 * nbytes, FP32_PEAK),
                               bound_ms(3 * flops, 2 * nbytes, TF32_PEAK)),
             fp32_library_ms=fp32["cuDNN x2"]),
    ]
    print(json.dumps({"kernels": [dict(k, **m) for k, m in zip(KERNELS, measured)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
