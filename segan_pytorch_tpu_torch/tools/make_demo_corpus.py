"""Synthesize the denoising demo corpus: the counterpart of the repo's
``tools/make_demo_corpus.py``, writing through the port's ``data/wav_io.write_wav``.

    python -m segan_pytorch_tpu_torch.tools.make_demo_corpus --out corpus \\
        [--n_train 200] [--n_test 16] [--dur 3.0] [--seed 1234] [--style v1|v2|whisper]

Speech-like clean utterances (harmonic stacks with a wandering f0, syllabic amplitude
envelope, light aspiration noise) plus band-limited noise mixed at a random 5-10 dB SNR,
or with ``--style whisper`` dewhispering pairs. Layout as ``SEDataset`` and ``train``
expect: parallel ``clean_<split>/`` and ``noisy_<split>/`` directories of identically
named pcm16 wavs, for the splits ``trainset`` and ``testset``. For the same seed and
style the wavs equal the JAX tool's byte for byte. It runs on the host (numpy only).
"""
import argparse
import os

import numpy as np

SR = 16000


def speechlike_utterance(rng: np.random.RandomState, n: int,
                         style: str = "v1") -> np.ndarray:
    t = np.arange(n) / SR
    # wandering pitch: random walk around a per-speaker base
    base_f0 = rng.uniform(90.0, 220.0)
    wob = rng.uniform(1.5, 3.5)
    f0 = base_f0 * (1.0 + 0.15 * np.sin(2 * np.pi * wob * t + rng.uniform(0, 6.28)))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    n_harm = rng.randint(4, 9)
    amps = 1.0 / np.arange(1, n_harm + 1) ** rng.uniform(0.8, 1.4)
    sig = sum(a * np.sin(k * phase + rng.uniform(0, 6.28))
              for k, a in enumerate(amps, start=1))
    # syllabic envelope: a few raised-cosine bursts per second + pauses
    syl = rng.uniform(2.0, 4.5)
    env = np.clip(np.sin(2 * np.pi * syl * t + rng.uniform(0, 6.28)), 0.0, None)
    env = env ** rng.uniform(0.7, 1.5)
    if style == "v1":
        # original corpus: CONSTANT aspiration noise — the pauses carry a
        # ~-34 dB incompressible noise floor that stays inside STOI's 40 dB
        # VAD and penalizes any enhancer that (correctly) suppresses it
        # (BENCH.md STOI-regression diagnosis; kept for reproducibility)
        sig = sig * env + 0.01 * rng.randn(n)
    else:
        # v2: breath noise rides the syllabic envelope, so pauses are true
        # silence (removed by STOI's VAD) and the voiced aspiration is part
        # of the target the enhancer should preserve
        sig = (sig + 0.02 * rng.randn(n)) * env
    sig = sig / (np.abs(sig).max() + 1e-9) * rng.uniform(0.3, 0.8)
    return sig.astype(np.float32)


def voiced_whisper_pair(rng: np.random.RandomState, n: int):
    """Dewhispering-style pair (the WSEGAN task, ref run_wsegan_train.sh:4-9:
    clean_trainset_M4 vs whisper_trainset_M4): the 'noisy' side is the SAME
    articulation (identical syllabic envelope, time-aligned) with the harmonic
    excitation replaced by speech-band noise — i.e. a synthetic whisper. The
    enhancer must REGENERATE voicing, not subtract additive noise, which is
    what WSEGAN's misalign/interf fake pairs and power loss target."""
    t = np.arange(n) / SR
    base_f0 = rng.uniform(90.0, 220.0)
    wob = rng.uniform(1.5, 3.5)
    f0 = base_f0 * (1.0 + 0.15 * np.sin(2 * np.pi * wob * t + rng.uniform(0, 6.28)))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    n_harm = rng.randint(4, 9)
    amps = 1.0 / np.arange(1, n_harm + 1) ** rng.uniform(0.8, 1.4)
    voiced = sum(a * np.sin(k * phase + rng.uniform(0, 6.28))
                 for k, a in enumerate(amps, start=1))
    syl = rng.uniform(2.0, 4.5)
    env = np.clip(np.sin(2 * np.pi * syl * t + rng.uniform(0, 6.28)), 0.0, None)
    env = env ** rng.uniform(0.7, 1.5)
    clean = (voiced + 0.02 * rng.randn(n)) * env  # v2-style breath noise
    # whisper excitation: speech-band (250-4000 Hz) noise with a gentle 1/f
    # tilt, modulated by the SAME envelope
    exc = rng.randn(n + 2 * SR)
    spec = np.fft.rfft(exc)
    freqs = np.fft.rfftfreq(exc.shape[0], 1.0 / SR)
    band = ((freqs >= 250.0) & (freqs <= 4000.0)).astype(np.float64)
    band = np.convolve(band, np.hanning(65) / np.hanning(65).sum(), mode="same")
    tilt = 1.0 / np.maximum(freqs / 500.0, 1.0)
    shaped = np.fft.irfft(spec * band * tilt, n=exc.shape[0])[SR:SR + n]
    whisper = shaped * env
    pc = np.sqrt(np.mean(clean ** 2) + 1e-12)
    pw = np.sqrt(np.mean(whisper ** 2) + 1e-12)
    whisper = whisper * (pc / pw) * rng.uniform(0.5, 0.8)  # whispers sit lower
    peak = max(np.abs(clean).max(), np.abs(whisper).max()) + 1e-9
    scale = rng.uniform(0.3, 0.8) / peak  # one scale: keep the pair's relation
    return ((clean * scale).astype(np.float32),
            (whisper * scale).astype(np.float32))


def bandlimited_noise(rng: np.random.RandomState, n: int) -> np.ndarray:
    white = rng.randn(n + 2 * SR)
    lo = rng.uniform(100.0, 800.0)
    hi = rng.uniform(1500.0, 6000.0)
    spec = np.fft.rfft(white)
    freqs = np.fft.rfftfreq(white.shape[0], 1.0 / SR)
    band = ((freqs >= lo) & (freqs <= hi)).astype(np.float64)
    # soft edges so the noise isn't ringy
    band = np.convolve(band, np.hanning(33) / np.hanning(33).sum(), mode="same")
    shaped = np.fft.irfft(spec * band, n=white.shape[0])[SR:SR + n]
    return shaped.astype(np.float32)


def mix_at_snr(clean: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    pc = np.mean(clean ** 2) + 1e-12
    pn = np.mean(noise ** 2) + 1e-12
    noise = noise * np.sqrt(pc / (pn * 10.0 ** (snr_db / 10.0)))
    noisy = clean + noise
    peak = np.abs(noisy).max()
    if peak > 0.99:  # anti-clip, preserves the SNR
        noisy = noisy / peak * 0.99
    return noisy.astype(np.float32)


def write_split(out: str, split: str, n_utts: int, dur: float, seed: int,
                style: str = "v1"):
    """Write utterances seed, seed + 1, ... of `split` into clean_<split>/ and
    noisy_<split>/ under `out`."""
    from ..data.wav_io import write_wav

    cdir = os.path.join(out, f"clean_{split}")
    ndir = os.path.join(out, f"noisy_{split}")
    os.makedirs(cdir, exist_ok=True)
    os.makedirs(ndir, exist_ok=True)
    n = int(dur * SR)
    for i in range(n_utts):
        rng = np.random.RandomState(seed + i)
        if style == "whisper":
            clean, noisy = voiced_whisper_pair(rng, n)
        else:
            clean = speechlike_utterance(rng, n, style=style)
            noisy = mix_at_snr(clean, bandlimited_noise(rng, n),
                               rng.uniform(5.0, 10.0))
        name = f"utt_{split}_{i:04d}.wav"
        write_wav(os.path.join(cdir, name), clean, SR, subtype="pcm16")
        write_wav(os.path.join(ndir, name), noisy, SR, subtype="pcm16")
    print(f"{split}: {n_utts} utterances ({dur:.1f}s each) -> {cdir} / {ndir}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--n_train", type=int, default=200)
    p.add_argument("--n_test", type=int, default=16)
    p.add_argument("--dur", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--style", choices=["v1", "v2", "whisper"], default="v1",
                   help="v1 = original (constant aspiration floor); v2 = breath "
                        "noise modulated by the syllabic envelope (pauses "
                        "are true silence, which STOI's VAD removes); "
                        "whisper = dewhispering pairs (noisy side is the same "
                        "articulation with noise excitation: the WSEGAN task)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    write_split(args.out, "trainset", args.n_train, args.dur, args.seed,
                style=args.style)
    write_split(args.out, "testset", args.n_test, args.dur, args.seed + 100000,
                style=args.style)


if __name__ == "__main__":
    main()
