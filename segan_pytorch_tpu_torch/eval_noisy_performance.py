"""Score a noisy testset against its clean references with the Hu-Loizou composite
metrics (CSIG/CBAK/COVL + PESQ + SSNR): the counterpart of the repo's
``eval_noisy_performance.py``, on the port's metrics (``metrics.CompositeEval``) and wav
reader (``data/wav_io.read_wav_16k``).

    python -m segan_pytorch_tpu_torch.eval_noisy_performance --test_wavs noisy/ \\
        --clean_wavs clean/ --logfile scores.txt

The logfile has the reference tool's layout: a header ``FILE CSIG CBAK COVL PESQ SSNR``
and one ``<name>.wav`` row per file, which equals the JAX tool's byte for byte. Pairing
is by basename: for every ``<test_wavs>/x.wav`` a ``<clean_wavs>/x.wav`` must exist. It
runs on the host alone (numpy, scipy and the native P.862 library).
"""
import argparse
import statistics
import time
from pathlib import Path


def score_pair(clean_path: Path, noisy_path: Path):
    """(csig, cbak, covl, pesq, ssnr) of one pair."""
    from .data.wav_io import read_wav_16k
    from .metrics import CompositeEval

    noisy, _ = read_wav_16k(str(noisy_path), 16000)
    clean, _ = read_wav_16k(str(clean_path), 16000)
    return CompositeEval(clean, noisy, True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Composite (CSIG/CBAK/COVL/PESQ/SSNR) evaluation of noisy "
                    "wavs vs clean references, paired by basename.")
    ap.add_argument("--test_wavs", required=True, type=Path,
                    help="directory of noisy/degraded wavs to score")
    ap.add_argument("--clean_wavs", required=True, type=Path,
                    help="directory of matching clean reference wavs")
    ap.add_argument("--logfile", required=True, type=Path,
                    help="output log (reference-compatible space-separated table)")
    return ap


def main(argv=None) -> dict:
    """Score every pair and write the logfile; returns the means by metric. Exits
    non-zero (SystemExit with a message) when a clean reference is missing or there is
    no wav to score."""
    opts = build_parser().parse_args(argv)
    pairs = []
    for noisy_path in sorted(opts.test_wavs.glob("*.wav")):
        clean_path = opts.clean_wavs / noisy_path.name
        if not clean_path.exists():
            raise SystemExit(f"no clean reference for {noisy_path.name} "
                             f"in {opts.clean_wavs}")
        pairs.append((clean_path, noisy_path))
    if not pairs:
        raise SystemExit(f"no wavs found in {opts.test_wavs}")

    sums = {"csig": 0.0, "cbak": 0.0, "covl": 0.0, "pesq": 0.0, "ssnr": 0.0}
    durations = []
    with open(opts.logfile, "w") as log:
        log.write("FILE CSIG CBAK COVL PESQ SSNR\n")
        for i, (clean_path, noisy_path) in enumerate(pairs, start=1):
            t0 = time.perf_counter()
            csig, cbak, covl, pesq, ssnr = score_pair(clean_path, noisy_path)
            durations.append(time.perf_counter() - t0)
            for key, val in zip(sums, (csig, cbak, covl, pesq, ssnr)):
                sums[key] += val
            log.write("{} {:.3f} {:.3f} {:.3f} {:.3f} {:.3}\n".format(
                noisy_path.name, csig, cbak, covl, pesq, ssnr))
            print(f"[{i}/{len(pairs)}] {noisy_path.name}: "
                  f"csig={csig:.3f} cbak={cbak:.3f} covl={covl:.3f} "
                  f"pesq={pesq:.3f} ssnr={ssnr:.3f} "
                  f"({durations[-1]:.2f}s, avg {statistics.mean(durations):.2f}s)")

    n = len(pairs)
    print(f"=== means over {n} files ===")
    for key in ("csig", "cbak", "covl", "pesq", "ssnr"):
        print(f"mean {key.upper()}: {sums[key] / n:.4f}")
    return {key: sums[key] / n for key in sums}


if __name__ == "__main__":
    main()
