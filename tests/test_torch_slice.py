"""The port's enhancement slice against the JAX package's: SEGAN.generate /
generate_batch with the same weights and the same explicit z, at toy width, and the
port's clean.py CLI run as a user runs it (python -m segan_pytorch_tpu_torch.clean)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch
from scipy.io import wavfile

from segan_pytorch_tpu.models.generator import build_generator as jax_build_g
from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.utils.checkpoint import (export_torch_generator, flatten_tree,
                                                unflatten_tree)
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.ops.signal import normalize_wave_minmax, pre_emphasize_np
from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts
from segan_pytorch_tpu_torch.utils.engine import build_enhancement_engine

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4],
           gkwidth=31, z_dim=32, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4],
           dpool_slen=16, no_bias=True)
G_TOL = 5e-5    # the toy G's output and bottleneck, as in test_torch_generator.py
# de-emphasis x[t] = 0.95 x[t-1] + y[t] sums up to 1/(1-0.95) = 20 G outputs
WAV_TOL = 20 * G_TOL
LENGTHS = [700, 1024, 2500]  # below, equal to and not a multiple of slice_size


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """A JAX engine with random G weights (slopes in U(0, 0.3)) and the port's engine
    loaded from the JAX engine's exported torch checkpoint."""
    jseg = JaxSEGAN(JaxConfig(**TOY, save_path=str(tmp_path_factory.mktemp("j"))))
    jseg.init_state(jax.random.PRNGKey(0), batch_size=1)
    rng = np.random.RandomState(0)
    flat = {}
    for path, v in flatten_tree(jseg.state.g_params).items():
        if path.endswith("act/weight"):
            flat[path] = rng.uniform(0, 0.3, v.shape)
        elif v.ndim == 3:
            flat[path] = rng.randn(*v.shape) / np.sqrt(v.shape[0] * v.shape[1])
        else:
            flat[path] = rng.randn(*v.shape) * 0.1 + (1.0 if "skip_k" in path else 0.0)
    params = unflatten_tree({k: np.asarray(v, np.float32) for k, v in flat.items()})
    jseg.state = jseg.state.replace(g_params=jax.device_put(params))
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "g.ckpt")
    export_torch_generator({"params": params}, ckpt)
    tseg = SEGAN(SEGANConfig(**TOY), device="cpu")
    tseg.g_load_pretrained(ckpt)
    return jseg, tseg, ckpt


def _wav(n, seed):
    return np.random.RandomState(seed).randn(n).astype(np.float32) * 0.3


@pytest.mark.parametrize("overlap", [0.0, 0.25])
@pytest.mark.parametrize("n", LENGTHS)
def test_generate_matches_jax(engines, n, overlap):
    jseg, tseg, _ = engines
    wav = _wav(n, seed=n)
    z = np.random.RandomState(n + 1).randn(16, 32).astype(np.float32)
    y_j, gc_j = jseg.generate(wav, z=z, overlap=overlap)
    y, gc = tseg.generate(wav, z=z, overlap=overlap)
    assert y.shape == (n,) and y.dtype == np.float32
    np.testing.assert_allclose(y, y_j, rtol=WAV_TOL, atol=WAV_TOL)
    np.testing.assert_allclose(gc, np.asarray(gc_j)[: gc.shape[0]], rtol=G_TOL, atol=G_TOL)


@pytest.mark.parametrize("overlap", [0.0, 0.25])
def test_generate_batch_matches_jax(engines, overlap):
    """JAX draws utterance i's z from the i-th split of rng; the same z rows go to the
    port explicitly."""
    jseg, tseg, _ = engines
    wavs = [_wav(n, seed=10 + n) for n in LENGTHS]
    key = jax.random.PRNGKey(3)
    res_j = jseg.generate_batch(wavs, rng=key, overlap=overlap)
    zs, rng = [], key
    for _ in wavs:
        rng, k = jax.random.split(rng)
        zs.append(np.asarray(jseg.G.sample_z(k, (1, 1024, 1)))[0])
    res = tseg.generate_batch(wavs, overlap=overlap, z=zs)
    for (y, gc), (y_j, gc_j), n in zip(res, res_j, LENGTHS):
        assert y.shape == (n,)
        np.testing.assert_allclose(y, y_j, rtol=WAV_TOL, atol=WAV_TOL)
        np.testing.assert_allclose(gc, np.asarray(gc_j), rtol=G_TOL, atol=G_TOL)


def test_generate_batch_equals_sequential_generate(engines):
    """Same seed, same z stream order: one batched pass == one generate() per wav."""
    _, tseg, ckpt = engines
    wavs = [_wav(n, seed=20 + n) for n in LENGTHS]
    seq, bat = SEGAN(SEGANConfig(**TOY), device="cpu"), SEGAN(SEGANConfig(**TOY), device="cpu")
    seq.g_load_pretrained(ckpt)
    bat.g_load_pretrained(ckpt)
    outs = [seq.generate(w) for w in wavs]
    for (y, gc), (y_s, gc_s) in zip(bat.generate_batch(wavs), outs):
        np.testing.assert_allclose(y, y_s, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gc, gc_s, rtol=1e-5, atol=1e-5)
    assert bat.generate_batch([]) == []
    with pytest.raises(ValueError):
        bat.generate(wavs[0], overlap=0.5)


def test_bf16_compute_dtype_runs_and_returns_fp32(engines):
    _, tseg, ckpt = engines
    bf = SEGAN(SEGANConfig(**TOY, compute_dtype="bfloat16"), device="cpu")
    bf.g_load_pretrained(ckpt)
    x = torch.from_numpy(_wav(2048, seed=30).reshape(2, 1024, 1))
    z = torch.from_numpy(np.random.RandomState(31).randn(2, 16, 32).astype(np.float32))
    y_bf, y32 = bf.infer_G(x, z), tseg.infer_G(x, z)
    assert y_bf.dtype == torch.float32
    assert next(bf.G.parameters()).dtype == torch.float32  # params stay fp32
    # bf16 keeps 8 bits of mantissa through 6 layers: a few 1e-3 of the output's range
    assert float((y_bf - y32).abs().max()) <= 3e-2 * float(y32.abs().max())


def test_clean_cli_writes_the_enhanced_wavs(engines, tmp_path):
    _, _, ckpt = engines
    cfg = SEGANConfig(**TOY, save_path=str(tmp_path))
    opts = dump_train_opts(cfg)
    noisy = tmp_path / "noisy"
    noisy.mkdir()
    for i, n in enumerate(LENGTHS):
        pcm = (_wav(n, seed=40 + i) * 20000).astype(np.int16)
        wavfile.write(str(noisy / f"u{i}.wav"), 16000, pcm)
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "segan_pytorch_tpu_torch.clean", "--g_pretrained_ckpt",
         ckpt, "--cfg_file", opts, "--test_files", str(noisy), "--synthesis_path",
         str(out), "--seed", "5", "--batch_utts", "2", "--device", "cpu"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Cleaned 3/3" in proc.stdout
    _, seg = build_enhancement_engine(opts, ckpt, seed=5, device="cpu")
    for i, n in enumerate(LENGTHS):
        rate, y = wavfile.read(str(out / f"u{i}.wav"))
        assert rate == 16000 and y.dtype == np.float32 and y.shape == (n,)
        _, pcm = wavfile.read(str(noisy / f"u{i}.wav"))
        want, _ = seg.generate(pre_emphasize_np(normalize_wave_minmax(pcm), cfg.preemph))
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


def test_engine_builds_a_bnorm_generator_from_its_opts_and_ckpt(tmp_path):
    """A bnorm generator's train.opts and its JAX-exported .ckpt (running statistics
    included) make an engine with G loaded strictly, whose eval forward equals the JAX
    G's. (WSEGAN's and AEWSEGAN's engines: test_torch_wsegan_engine.py.)"""
    from test_torch_discriminator import randomize

    cfg = dict(TOY, gnorm_type="bnorm")
    G = jax_build_g(JaxConfig(**cfg))
    flat = randomize(dict(G.init({"params": jax.random.PRNGKey(0), "z":
                                  jax.random.PRNGKey(1)}, np.zeros((1, 1024, 1),
                                                                   np.float32),
                                 train=True)), seed=3)
    tree = unflatten_tree(flat)
    ckpt = str(tmp_path / "g.ckpt")
    export_torch_generator(tree, ckpt)
    opts = dump_train_opts(SEGANConfig(**cfg), str(tmp_path / "bn"))
    _, seg = build_enhancement_engine(opts, ckpt, device="cpu")
    assert type(seg) is SEGAN and not seg.G.training
    assert all(blk.norm is not None for blk in list(seg.G.enc_blocks) + list(
        seg.G.dec_blocks))
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 1024, 1) * 0.3).astype(np.float32)
    z = rng.randn(2, 16, 32).astype(np.float32)
    y_j = np.asarray(G.apply(tree, x, z=z, train=False))
    y = seg.infer_G(x, z).numpy()
    np.testing.assert_allclose(y, y_j, rtol=G_TOL, atol=G_TOL * np.abs(y_j).max())
