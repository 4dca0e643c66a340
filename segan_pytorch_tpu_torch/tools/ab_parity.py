"""Released-checkpoint parity harness (the BASELINE.md gate): the counterpart of the
repo's ``tools/ab_parity.py``, enhancing through the port's ``SEGAN`` / ``WSEGAN``.

Given a generator checkpoint (a torch ``.ckpt`` such as upstream's released
``segan+_generator.ckpt``, or the JAX trainer's npz), a train.opts config and a
clean/noisy test directory pair, it runs the reference enhancement pipeline (normalize
-> pre-emphasis -> chunked ``generate`` -> de-emphasis, as ``clean`` does) and writes
the BASELINE.md metric rows: PESQ / STOI / CSIG / CBAK / COVL / SSNR of the noisy input
and of the enhanced output, per file and as means, beside the paper's rows.

    python -m segan_pytorch_tpu_torch.tools.ab_parity --g_ckpt segan+_generator.ckpt \\
        --cfg_file ckpt_segan+/train.opts --clean_test <clean wavs> \\
        --noisy_test <noisy wavs> [--ab_torch] [--out parity_report.json] [--device cpu]

G runs on the CUDA card, and the tool raises without one; ``--device cpu`` asks for
the CPU. Each utterance takes one z draw from the engine's stream (seeded by
``--seed``), shared by its chunks.

``--ab_torch`` also runs upstream's own PyTorch Generator, loaded on the CPU from a
checkout of upstream's repository at ``REFERENCE`` (where the repo's reference-parity
tests look for it), on the same inputs, checkpoint and z, and reports the waveform A/B
(max sample difference, difference SNR) and its metric rows. No machine this port has
run on had that checkout, so no test or smoke run covers it.
"""
import argparse
import glob
import json
import os
import sys

import numpy as np

PAPER_ROWS = {  # arXiv:1703.09452 Table 1 (Valentini 28-spk testset)
    "noisy": {"pesq": 1.97, "csig": 3.35, "cbak": 2.44, "covl": 2.63, "ssnr": 1.68},
    "segan": {"pesq": 2.16, "csig": 3.48, "cbak": 2.94, "covl": 2.80, "ssnr": 7.73},
}
REFERENCE = os.path.join(os.sep, "root", "reference", "segan")  # upstream's checkout


def load_reference_torch_generator(cfg, ckpt_path):
    """Upstream's own torch Generator (``REFERENCE``/models/generator.py) with this
    config and the checkpoint loaded into it, on the CPU, for the A/B."""
    import importlib.util
    import types

    import torch

    for name in ("numba", "soundfile", "librosa", "tensorboardX", "torchvision",
                 "torchvision.utils", "ahoproc_tools", "ahoproc_tools.io",
                 "ahoproc_tools.interpolate"):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            if name == "numba":
                mod.jit = lambda *a, **k: (lambda f: f)
                mod.int32 = mod.float32 = None
            if name == "tensorboardX":
                mod.SummaryWriter = object
            sys.modules[name] = mod
    sys.path.insert(0, os.path.join(REFERENCE, "models"))
    spec = importlib.util.spec_from_file_location(
        "ref_generator", os.path.join(REFERENCE, "models", "generator.py"))
    ref_gen = importlib.util.module_from_spec(spec)
    sys.modules["ref_generator"] = ref_gen
    spec.loader.exec_module(ref_gen)

    RG = ref_gen.Generator(
        1, cfg.genc_fmaps, cfg.gkwidth, cfg.genc_poolings,
        dec_fmaps=cfg.gdec_fmaps, dec_kwidth=cfg.gdec_kwidth,
        dec_poolings=cfg.gdec_poolings,
        z_dim=cfg.z_dim, no_z=cfg.no_z, skip=not cfg.no_skip,
        bias=cfg.bias, skip_init=cfg.skip_init,
        skip_dropout=getattr(cfg, "skip_dropout", 0),
        skip_type=cfg.skip_type, norm_type=cfg.gnorm_type,
        skip_merge=cfg.skip_merge, skip_kwidth=cfg.skip_kwidth)
    st = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if "state_dict" in st:
        st = st["state_dict"]
    RG.load_state_dict(st, strict=False)
    RG.eval()
    return RG


def reference_generate(RG, pwav, z, slice_size):
    """Upstream's chunked inference loop (its model.py:116-157): sequential chunks of
    `slice_size`, the tail zero-padded, one z (1, T', z_dim) shared by the chunks."""
    import torch

    zt = None
    if z is not None:
        zt = torch.from_numpy(
            np.ascontiguousarray(np.asarray(z, np.float32).transpose(0, 2, 1)))
    out = []
    with torch.no_grad():
        for beg in range(0, len(pwav), slice_size):
            chunk = pwav[beg:beg + slice_size]
            pad = slice_size - len(chunk)
            if pad > 0:
                chunk = np.concatenate([chunk, np.zeros(pad, np.float32)])
            x = torch.from_numpy(chunk.astype(np.float32))[None, None, :]
            y = RG(x, z=zt) if zt is not None else RG(x)
            out.append(y.numpy().reshape(-1))
    return np.concatenate(out)[:len(pwav)]


def score(clean, enh):
    """The six metrics of one utterance against its clean reference."""
    from ..metrics import CompositeEval
    from ..metrics.stoi import stoi

    csig, cbak, covl, pesq, ssnr = CompositeEval(clean, enh, True)
    return {"pesq": float(pesq), "stoi": float(stoi(clean, enh, 16000)),
            "csig": float(csig), "cbak": float(cbak), "covl": float(covl),
            "ssnr": float(ssnr)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--g_ckpt", required=True,
                    help="generator checkpoint (torch .ckpt or the JAX trainer's npz)")
    ap.add_argument("--cfg_file", required=True, help="train.opts JSON")
    ap.add_argument("--clean_test", required=True)
    ap.add_argument("--noisy_test", required=True)
    ap.add_argument("--out", default="parity_report.json")
    ap.add_argument("--ab_torch", action="store_true",
                    help="also run upstream's torch Generator (from "
                         f"{REFERENCE}, which must exist) for a waveform A/B")
    ap.add_argument("--max_files", type=int, default=0, help="0 = all")
    ap.add_argument("--seed", type=int, default=111)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where G runs (Def: cuda, which raises without a card)")
    return ap


def main(argv=None) -> dict:
    """Enhance and score every file; writes the report to --out and returns it."""
    args = build_parser().parse_args(argv)
    from ..data.wav_io import read_wav_raw
    from ..models.segan import SEGAN
    from ..models.wsegan import WSEGAN
    from ..ops.signal import (de_emphasize_np, div_n_len, normalize_wave_minmax,
                              pre_emphasize_np)
    from ..utils.config import load_train_opts

    cfg = load_train_opts(args.cfg_file)
    segan = (WSEGAN if cfg.wsegan else SEGAN)(cfg, device=args.device, seed=args.seed)
    segan.g_load_pretrained(args.g_ckpt)

    RG = None
    if args.ab_torch:
        RG = load_reference_torch_generator(cfg, args.g_ckpt)

    noisy_files = sorted(glob.glob(os.path.join(args.noisy_test, "*.wav")))
    if args.max_files:
        noisy_files = noisy_files[: args.max_files]
    if not noisy_files:
        raise SystemExit(f"no wavs in {args.noisy_test}")

    rows = []
    agg = {"noisy": [], "enh": [], "enh_torch": []}
    ab = {"max_diff": 0.0, "diff_snr_db": []}
    for i, nf in enumerate(noisy_files, 1):
        bname = os.path.basename(nf)
        cf = os.path.join(args.clean_test, bname)
        if not os.path.exists(cf):
            raise SystemExit(f"missing clean reference {cf}")
        _, nwav = read_wav_raw(nf)
        _, cwav = read_wav_raw(cf)
        pwav = pre_emphasize_np(normalize_wave_minmax(np.asarray(nwav)), cfg.preemph)
        clean = np.asarray(normalize_wave_minmax(np.asarray(cwav)), np.float32)
        noisy_scored = np.asarray(normalize_wave_minmax(np.asarray(nwav)), np.float32)

        # the draw generate() would make itself, kept for the A/B
        z = None if segan.G.no_z else segan._z_row(
            None, div_n_len(len(pwav), 1024) if cfg.wsegan else None).numpy()
        enh, _ = segan.generate(pwav, z=z)
        r = {"file": bname, "noisy": score(clean, noisy_scored),
             "enh": score(clean, enh.astype(np.float32))}
        agg["noisy"].append(r["noisy"])
        agg["enh"].append(r["enh"])

        if RG is not None:
            raw = reference_generate(RG, pwav, z, cfg.slice_size)
            enh_t = de_emphasize_np(raw.astype(np.float32), cfg.preemph)
            r["enh_torch"] = score(clean, enh_t)
            agg["enh_torch"].append(r["enh_torch"])
            d = enh.astype(np.float64) - enh_t.astype(np.float64)
            ab["max_diff"] = max(ab["max_diff"], float(np.max(np.abs(d))))
            p_sig = float(np.mean(enh_t.astype(np.float64) ** 2)) + 1e-20
            p_d = float(np.mean(d ** 2)) + 1e-20
            ab["diff_snr_db"].append(10 * np.log10(p_sig / p_d))
        rows.append(r)
        print(f"[{i}/{len(noisy_files)}] {bname} "
              f"noisy PESQ {r['noisy']['pesq']:.2f} -> enh {r['enh']['pesq']:.2f}")

    def means(lst):
        return {k: float(np.mean([x[k] for x in lst])) for k in lst[0]} if lst else {}

    report = {
        "n_files": len(rows),
        "means": {k: means(v) for k, v in agg.items() if v},
        "paper_rows": PAPER_ROWS,
        "rows": rows,
    }
    if RG is not None:
        report["ab"] = {"max_sample_diff": ab["max_diff"],
                        "mean_diff_snr_db": float(np.mean(ab["diff_snr_db"]))}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)

    print("\n=== BASELINE.md rows (means) ===")
    hdr = ["pesq", "stoi", "csig", "cbak", "covl", "ssnr"]
    print("system   " + "  ".join(f"{h:>6s}" for h in hdr))
    for sys_name, m in report["means"].items():
        print(f"{sys_name:8s} " + "  ".join(f"{m[h]:6.3f}" for h in hdr))
    if RG is not None:
        print(f"\nA/B parity vs reference torch: max|diff|={ab['max_diff']:.2e}, "
              f"mean diff-SNR={report['ab']['mean_diff_snr_db']:.1f} dB")
    print(f"report -> {args.out}")
    return report


if __name__ == "__main__":
    main()
