#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (segan_pytorch_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no CPU fallback; it exits non-zero without a CUDA card
and when the port's package is not beside it):
  1. device facts: torch, nvcc and nvidia-smi (card name and power limit);
  2. build both hand-written kernels from segan_pytorch_tpu_torch/csrc/, one nvcc each,
     started together;
  3. the per-layer kernel (fused_conv1d_prelu) vs its plain PyTorch version on the
     card, at the five SEGAN+ encoder shapes for 1 and 8 16384-sample chunks and two
     ragged shapes, fp32 (TF32 off, relative error <= 1e-4) and bf16 (<= 2e-2), into
     NaN-filled outputs, with per-layer times (CUDA events, median of 20 after 3 warm-ups);
  3b. the chained kernel (fused_enc23_fwd: fp32 FMAs, bf16 on the tensor cores) vs
     enc23_plain, into NaN-filled outputs, at the SEGAN+ enc2+enc3 widths (h1 (B, 64,
     4096) -> 128 -> 256) for B = 1, 8 and 300, with and without bias, and at two narrow
     odd shapes, in fp32 and bf16 with the same limits; at B = 300 also vs the per-layer
     kernel chain. Times of the three arms of the A/B tool at B = 1, 8 and 300, fp32 and
     bf16. A bf16 call with C3 = 36 must raise ValueError (whole n8 tiles) and launch
     nothing;
  3c. the A/B tool (python -m segan_pytorch_tpu_torch.tools.encoder_fused_bench) at its
     defaults, batch 300 bf16: both kernels must launch in it, and the chained kernel's
     outputs must agree with the plain chain within 2e-2;
  4. the slice: a full-width SEGAN+ generator (seeded init, PReLU slopes U(0, 0.3))
     saved as a reference-format .ckpt + train.opts, then the port's clean.py CLI on
     8 synthetic wavs with --batch_utts 1 and 4. Checks: outputs finite and of their
     inputs' lengths, the kernel launched 5 times per G forward, batched == sequential,
     and the card's generate() == a CPU copy's (plain ops) within 1e-3 relative. Prints
     audio seconds enhanced per wall second and G chunks/s at batch 64.
The line before the last is the JSON kernel report (launches of fused_conv1d_prelu
from phase 4, of fused_enc23_fwd from phase 3c); the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        built = list(pool.map(build.build_library, names))
    secs = time.perf_counter() - t0
    for name, (path, log) in zip(names, built):
        print(f"build: {name} ({'compiled' if log is not None else 'already built'}) "
              f"-> {path}")
        if log:
            print(log.strip())
    print(f"build: {len(names)} kernels in {secs:.2f} s")


def phase_kernel():
    """Kernel vs plain on the card, at the encoder shapes of one chunk (clean.py on a
    short wav) and of batch 8, and at two ragged shapes. Returns (max fp32 abs error
    at the encoder shapes, kernel ms, plain ms), the times summed over the five
    encoder layers at batch 8."""
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import cuda_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED)
    T, Kw, S = 16384, 31, 4
    chans = [1, 64, 128, 256, 512, 1024]
    cases = []  # (label, B, Cin, T_in, Cout, K, stride, bias, main_path)
    for B in (1, 8):
        t = T
        for i in range(5):
            cases.append((f"B={B} enc{i + 1}", B, chans[i], t + Kw - 2, chans[i + 1], Kw, S,
                          False, True))
            t //= S
    cases.append(("ragged T_out=243", 3, 5, 1000, 70, Kw, S, True, False))
    cases.append(("stride 1", 2, 48, 300, 40, Kw, 1, True, False))
    max_abs = 0.0
    totals = {}  # B -> [kernel ms, plain ms] over the encoder layers
    print(f"{'layer':>17} {'x shape':>18} {'Cout':>5} {'T_out':>5} | "
          f"{'rel fp32':>9} {'rel bf16':>9} | {'kernel ms':>9} {'plain ms':>9} | "
          f"{'bf16 k ms':>9} {'bf16 p ms':>9}")
    for label, b, cin, t_in, cout, kw, s, has_bias, main in cases:
        x = torch.randn((b, cin, t_in), generator=g).cuda()
        w = (torch.randn((cout, cin, kw), generator=g) / (cin * kw) ** 0.5).cuda()
        bias = (torch.randn((cout,), generator=g) * 0.1).cuda() if has_bias else None
        a = (torch.rand((cout,), generator=g) * 0.3).cuda()
        t_out = K._check(x, w, bias, a, s)
        shape = (b, cout, t_out)
        assert t_out == (t_in - kw) // s + 1, (label, t_out)
        y, pre = K._launch(x, w, bias, a, s, t_out,
                           out=nan_outputs(shape, shape, dtype=x.dtype))
        y_ref, pre_ref = K.conv1d_prelu_plain(x, w, bias, a, s)
        torch.cuda.synchronize()
        e32 = worst([rel_err(y, y_ref), rel_err(pre, pre_ref)])
        assert e32 <= FP32_TOL, f"{label}: fp32 kernel vs plain rel err {e32:.3e} > {FP32_TOL}"
        if main:
            max_abs = worst([max_abs, float((y - y_ref).abs().max()),
                             float((pre - pre_ref).abs().max())])
        hb = [v.bfloat16() if v is not None else None for v in (x, w, bias, a)]
        yb, preb = K._launch(*hb, s, t_out,
                             out=nan_outputs(shape, shape, dtype=torch.bfloat16))
        yb_ref, preb_ref = K.conv1d_prelu_plain(*hb, s)
        torch.cuda.synchronize()
        assert yb.dtype == torch.bfloat16
        e16 = worst([rel_err(yb, yb_ref), rel_err(preb, preb_ref)])
        assert e16 <= BF16_TOL, f"{label}: bf16 kernel vs plain rel err {e16:.3e} > {BF16_TOL}"
        k_ms = cuda_ms(lambda: K.fused_conv1d_prelu(x, w, bias, a, s))
        p_ms = cuda_ms(lambda: K.conv1d_prelu_plain(x, w, bias, a, s))
        kb_ms = cuda_ms(lambda: K.fused_conv1d_prelu(*hb, s))
        pb_ms = cuda_ms(lambda: K.conv1d_prelu_plain(*hb, s))
        if main:
            tot = totals.setdefault(b, [0.0, 0.0])
            tot[0] += k_ms
            tot[1] += p_ms
        print(f"{label:>17} {str((b, cin, t_in)):>18} {cout:>5} {t_out:>5} | "
              f"{e32:9.2e} {e16:9.2e} | {k_ms:9.4f} {p_ms:9.4f} | {kb_ms:9.4f} {pb_ms:9.4f}")
    for b, (k_ms, p_ms) in totals.items():
        print(f"encoder total (B={b}, fp32): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return max_abs, totals[8][0], totals[8][1]


def phase_enc23():
    """The chained kernel vs enc23_plain on the card, into NaN-filled outputs; at B = 300
    also vs the per-layer kernel chain. Returns the max fp32 abs error at the SEGAN+
    widths."""
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
    from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 4)
    cases = [  # (label, B, T1, C1, C2, C3, bias, SEGAN+ widths)
        ("B=1", 1, 4096, 64, 128, 256, False, True),
        ("B=8", 8, 4096, 64, 128, 256, False, True),
        ("B=300", 300, 4096, 64, 128, 256, False, True),
        ("B=8 bias", 8, 4096, 64, 128, 256, True, True),
        ("narrow T1=64", 3, 64, 5, 24, 40, True, False),
        ("ragged tile T1=592", 2, 592, 5, 24, 40, False, False),
    ]
    timed = {(label, dtype) for label in ("B=1", "B=8", "B=300")
             for dtype in (torch.float32, torch.bfloat16)}
    max_abs = 0.0
    print(f"{'case':>18} {'dtype':>8} | {'rel err':>9} {'vs x2':>9} | "
          f"{'plain ms':>9} {'x2 ms':>9} {'fused ms':>9}")
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
            got = EF._launch(*args, out=nan_outputs(*shapes, dtype=dtype))
            ref = EF.enc23_plain(*args)
            torch.cuda.synchronize()
            err = worst(rel_err(o, r) for o, r in zip(got, ref))
            assert err <= tol, f"{label} {dtype}: chained vs plain rel err {err:.3e} > {tol}"
            if full and dtype == torch.float32:
                max_abs = worst([max_abs] + [float((o - r).abs().max())
                                             for o, r in zip(got, ref)])
            err_x2 = float("nan")
            if b == 300:
                err_x2 = worst(rel_err(o, r) for o, r in zip(got, bench.kernel_x2(*args)))
                assert err_x2 <= tol, f"{label} {dtype}: chained vs kernel x2 {err_x2:.3e}"
            del got, ref
            line = f"{label:>18} {str(dtype)[6:]:>8} | {err:9.2e} {err_x2:9.2e} |"
            if (label, dtype) in timed:
                line += " ".join(f"{bench.cuda_ms(lambda: arm(*args)):9.4f}"
                                 for arm in bench.ARMS.values())
            print(line, flush=True)
    bad = [(torch.randn(s, generator=g) * 0.1).cuda().bfloat16()
           for s in ((1, 5, 64), (24, 5, EF.K), (24,), (24,), (36, 24, EF.K), (36,), (36,))]
    before = EF.launches
    try:
        EF.fused_enc23_fwd(*bad)
    except ValueError as e:
        print(f"bf16 C3 = 36 refused: {e}")
    else:
        raise AssertionError("the bf16 kernel took C3 = 36, which is not whole n8 tiles")
    assert EF.launches == before, "a refused call launched the kernel"
    return max_abs


def phase_tool():
    """The A/B tool at its defaults (batch 300, bf16), the path of the chained kernel.
    Returns its results and the launches of both kernels in it."""
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
    from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench

    K.launches = EF.launches = 0
    res = bench.main([])
    torch.cuda.synchronize()
    counts = {"fused_conv1d_prelu": K.launches, "fused_enc23_fwd": EF.launches}
    print(f"kernel launches in the A/B tool: {counts}")
    assert all(n > 0 for n in counts.values()), counts
    assert all(e <= BF16_TOL for e in res["rel"].values()), res["rel"]
    return res, counts


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
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import cuda_ms
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

    outs = {}
    K.launches = 0
    n_forwards = 0
    for b in (1, 4):
        out_dir = work / f"synth_b{b}"
        out_dir.mkdir()
        args = clean.build_parser().parse_args([
            "--g_pretrained_ckpt", str(ckpt), "--cfg_file", opts_file,
            "--test_files", str(wav_dir), "--synthesis_path", str(out_dir),
            "--seed", str(SEED), "--batch_utts", str(b)])
        t0 = time.perf_counter()
        clean.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_forwards += -(-len(lengths) // b)
        print(f"clean.py --batch_utts {b}: {audio_s / wall:.2f} s of audio per wall second "
              f"({audio_s:.2f} s in {wall:.3f} s, model load included)")
        outs[b] = []
        for i, n in enumerate(lengths):
            path = out_dir / f"utt{i}.wav"
            assert path.exists(), f"missing output {path}"
            _, y = read_wav_raw(str(path))
            assert y.shape == (n,), f"{path}: {y.shape} != ({n},)"
            assert np.isfinite(y).all(), f"{path}: non-finite samples"
            outs[b].append(y)
    launches = K.launches
    print(f"kernel launches on the main path: {launches} for {n_forwards} G forwards")
    assert launches >= 5 * n_forwards, f"{launches} launches < 5 per G forward"
    for y1, y4 in zip(outs[1], outs[4]):
        e = float(np.abs(y1 - y4).max() / np.abs(y1).max())
        assert e <= FP32_TOL, f"batched vs sequential rel err {e:.3e}"

    # the card vs a CPU copy of the same model (plain ops), same z
    gpu = SEGAN(cfg, device="cuda", seed=SEED)
    gpu.g_load_pretrained(str(ckpt))
    cpu = SEGAN(cfg, device="cpu", seed=SEED)
    cpu.g_load_pretrained(str(ckpt))
    wav = np.random.RandomState(SEED + 1).randn(lengths[3]).astype(np.float32) * 0.3
    z = np.random.RandomState(SEED + 2).randn(16, cfg.z_dim).astype(np.float32)
    y_gpu, gc_gpu = gpu.generate(wav, z=z)
    y_cpu, gc_cpu = cpu.generate(wav, z=z)
    e_wav = float(np.abs(y_gpu - y_cpu).max() / np.abs(y_cpu).max())
    e_gc = float(np.abs(gc_gpu - gc_cpu).max() / np.abs(gc_cpu).max())
    print(f"card vs CPU generate(): rel err {e_wav:.3e} (wav), {e_gc:.3e} (g_c)")
    assert e_wav <= SLICE_TOL and e_gc <= SLICE_TOL, (e_wav, e_gc)
    del cpu

    x64 = torch.from_numpy(np.random.RandomState(SEED + 3).randn(
        64, cfg.slice_size, 1).astype(np.float32) * 0.3).cuda()
    z64 = gpu.G.sample_z(tuple(x64.shape), torch.Generator().manual_seed(SEED)).cuda()
    ms = cuda_ms(lambda: gpu.infer_G(x64, z64), reps=10, warmup=2)
    print(f"G forward at batch 64 (fp32): {ms:.3f} ms, {64e3 / ms:.1f} chunks/s")
    cfg_bf16 = SEGANConfig(no_bias=True, compute_dtype="bfloat16")
    bf = SEGAN(cfg_bf16, generator=gpu.G, device="cuda")
    y_bf = bf.infer_G(x64, z64)
    y32 = gpu.infer_G(x64, z64)
    e_bf = rel_err(y_bf, y32)
    ms_bf = cuda_ms(lambda: bf.infer_G(x64, z64), reps=10, warmup=2)
    print(f"G forward at batch 64 (bf16): {ms_bf:.3f} ms, {64e3 / ms_bf:.1f} chunks/s, "
          f"rel err vs fp32 {e_bf:.3e}")
    # a sanity bound: bf16 rounds every one of the 10 layers' inputs and outputs
    assert torch.isfinite(y_bf).all() and e_bf <= 0.1, e_bf
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
    max_abs, k_ms, p_ms = phase_kernel()
    enc23_abs = phase_enc23()
    tool, tool_launches = phase_tool()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        launches = phase_slice(Path(work))
    measured = [
        dict(launches=launches, max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms),
        dict(launches=tool_launches["fused_enc23_fwd"], max_abs_err=enc23_abs,
             ms=tool["ms"]["fused 2+3"], plain_ms=tool["ms"]["plain chain"]),
    ]
    print(json.dumps({"kernels": [dict(k, **m) for k, m in zip(KERNELS, measured)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
