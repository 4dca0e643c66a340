"""The port's WSEGAN and AEWSEGAN engines beside their train step: enhancement
(``generate``, ``generate_batch``: one G pass over the utterance padded by
``make_div_n(1024)``) against the JAX engine with the same z, the enhancement engine's
dispatch and the clean CLI on a WSEGAN checkpoint, the AEWSEGAN step against
``make_ae_train_step`` (L1 and MSE), and ``evaluate_sd``; at toy width on the CPU."""
import argparse
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models.wsegan import AEWSEGAN as JaxAEWSEGAN, WSEGAN as JaxWSEGAN
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch import clean as tclean
from segan_pytorch_tpu_torch.data.wav_io import read_wav_raw
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import (AEWSEGAN, WSEGAN,
                                                   apply_wsegan_weights_init)
from segan_pytorch_tpu_torch.ops.signal import normalize_wave_minmax, pre_emphasize_np
from segan_pytorch_tpu_torch.utils.checkpoint import generator_state_from_jax, save_generator
from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts
from segan_pytorch_tpu_torch.utils.engine import build_enhancement_engine
from test_torch_data import write_pairs
from test_torch_wsegan_models import snorm_randomize

TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
           z_dim=32, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16,
           gnorm_type="snorm")
TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """A JAX WSEGAN with random weights, u and v, and the port's with the same G."""
    tmp = tmp_path_factory.mktemp("gen")
    jseg = JaxWSEGAN(JaxConfig(**TOY, wsegan=True, save_path=str(tmp)))
    jseg.init_state(jax.random.PRNGKey(0), batch_size=1)
    flat = snorm_randomize({"params": jseg.state.g_params, **jseg.state.g_vars}, seed=3)
    tree = unflatten_tree(flat)
    jseg.state = jseg.state.replace(g_params=tree["params"],
                                    g_vars={"spectral": tree["spectral"]})
    G = build_generator(SEGANConfig(**TOY))
    G.load_state_dict(generator_state_from_jax(flat), strict=True)
    seg = WSEGAN(SEGANConfig(**TOY, wsegan=True), generator=G, device="cpu")
    return jseg, seg


def _wav(n, seed):
    return (np.random.RandomState(seed).randn(n) * 0.2).astype(np.float32)


@pytest.mark.parametrize("n", [3000, 2048, 5000], ids=["ragged", "T%1024==0", "long"])
def test_generate_matches_jax(engines, n):
    """One G pass over the utterance padded to the next multiple of 1024, a full 1024
    more when it is one already (upstream's make_div_n), with the given z."""
    jseg, seg = engines
    wav = _wav(n, seed=n)
    L = n + 1024 - n % 1024
    z = np.random.RandomState(1).randn(1, L // 64, 32).astype(np.float32)
    want, hall_j = jseg.generate(wav, z=jnp.asarray(z))
    got, hall = seg.generate(wav, z=z)
    assert got.shape == (n,) and _rel(got, want) <= TOL
    assert hall["enc_0"].shape == (1, L // 4, 8) == np.shape(hall_j["enc_0"])
    assert _rel(hall["enc_2"].numpy(), hall_j["enc_2"]) <= TOL


def test_generate_batch_matches_jax_and_generate(engines):
    """Utterances grouped by padded length, each group one G pass: equal to the JAX
    generate_batch with the z of its per-utterance keys, and to one generate() each with
    the engine's own z stream."""
    jseg, seg = engines
    lengths = [3000, 2048, 5000, 2500]
    wavs = [_wav(n, seed=10 + i) for i, n in enumerate(lengths)]
    keys = list(jax.random.split(jax.random.PRNGKey(4), len(wavs)))
    want = jseg.generate_batch(wavs, rngs=keys)
    zs = [np.asarray(jax.random.normal(k, (1, (n + 1024 - n % 1024) // 64, 32)))
          for k, n in zip(keys, lengths)]
    got = seg.generate_batch(wavs, z=zs)
    for (g, hall), (w, hall_j), n in zip(got, want, lengths):
        assert g.shape == (n,) and _rel(g, w) <= TOL
        assert hall["enc_1"].shape[0] == 1
    # the engine's own stream: the i-th utterance takes the i-th draw, whatever its group
    a = WSEGAN(seg.cfg, generator=seg.G, device="cpu", seed=9)
    b = WSEGAN(seg.cfg, generator=seg.G, device="cpu", seed=9)
    batched = a.generate_batch(wavs)
    for w, (g, _) in zip(wavs, batched):
        np.testing.assert_allclose(g, b.generate(w)[0], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        seg.generate_batch(wavs, z=zs[:2])
    assert seg.generate_batch([]) == []


def test_engine_builds_each_family_and_aewsegan_first(engines, tmp_path):
    """train.opts of a WSEGAN run gives the WSEGAN engine, of an AEWSEGAN run (wsegan
    False, aewsegan True) the AEWSEGAN one, checked first as in JAX; both enhance with
    the one padded pass, which differs from SEGAN's chunk grid."""
    _, seg = engines
    ckpt = str(tmp_path / "g.ckpt")
    save_generator(seg.G, ckpt)
    wav = _wav(3000, seed=5)
    outs = {}
    for name, kw in (("wsegan", dict(wsegan=True)), ("aewsegan", dict(aewsegan=True)),
                     ("segan", {})):
        opts = dump_train_opts(SEGANConfig(**TOY, **kw), str(tmp_path / name))
        _, eng = build_enhancement_engine(opts, ckpt, seed=5, device="cpu")
        assert type(eng) is {"wsegan": WSEGAN, "aewsegan": AEWSEGAN, "segan": SEGAN}[name]
        outs[name] = eng.generate(wav)[0]
    np.testing.assert_array_equal(outs["wsegan"], outs["aewsegan"])
    assert not np.allclose(outs["wsegan"], outs["segan"], atol=1e-3)


def test_clean_cli_enhances_a_wsegan_checkpoint_in_one_pass(engines, tmp_path):
    """The port's clean CLI with --device cpu, one utterance at a time and four at once:
    each output equals the engine's generate() with the same seed, in order."""
    _, seg = engines
    ckpt = str(tmp_path / "g.ckpt")
    save_generator(seg.G, ckpt)
    opts_file = dump_train_opts(SEGANConfig(**TOY, wsegan=True), str(tmp_path / "ck"))
    noisy_dir = write_pairs(tmp_path / "wavs", [3000, 2048, 4100])[1]
    names = sorted(os.listdir(noisy_dir))
    _, ref = build_enhancement_engine(opts_file, ckpt, seed=7, device="cpu")
    want = []
    for name in names:
        _, pcm = read_wav_raw(os.path.join(noisy_dir, name))
        want.append(ref.generate(pre_emphasize_np(normalize_wave_minmax(pcm), 0.95))[0])
    for batch_utts in (1, 4):
        out = tmp_path / f"out{batch_utts}"
        out.mkdir()
        tclean.main(argparse.Namespace(
            cfg_file=opts_file, test_files=[noisy_dir], g_pretrained_ckpt=ckpt, seed=7,
            device="cpu", h5=False, soundfile=False, batch_utts=batch_utts, overlap=0.0,
            synthesis_path=str(out)))
        for name, w in zip(names, want):
            _, y = read_wav_raw(str(out / name))
            assert y.shape == w.shape
            np.testing.assert_allclose(y, w, rtol=1e-6, atol=1e-6)


def test_wsegan_init_is_xavier_everywhere():
    """Every weight of two or more dimensions (the snorm ones' weight_orig) is
    U(+-sqrt(6 / (fan_in + fan_out))) with torch's fans, deconvs' too; slopes, biases and
    skips keep their values."""
    cfg = SEGANConfig(**TOY, wsegan=True, dnorm_type="snorm")
    G = build_generator(cfg)
    before = {k: v.clone() for k, v in G.state_dict().items()}
    apply_wsegan_weights_init(G, torch.Generator().manual_seed(0))
    for name, p in G.named_parameters():
        if p.dim() >= 2 and name.endswith(("weight", "weight_orig")):
            fan_sum = (p.shape[0] + p.shape[1]) * int(np.prod(p.shape[2:]))
            a = np.sqrt(6.0 / fan_sum)
            assert float(p.abs().max()) <= a and float(p.abs().max()) > 0.9 * a, name
            assert abs(float(p.std()) - a / np.sqrt(3)) < 0.1 * a, name
        else:
            assert torch.equal(p, before[name]), name


# -- AEWSEGAN --------------------------------------------------------------------------
@pytest.mark.parametrize("reg_loss,gnorm", [("l1_loss", "snorm"), ("mse_loss", None)])
def test_ae_step_matches_jax(reg_loss, gnorm, tmp_path):
    """One G step on the masked L1 (or MSE) of Genh against clean, Adam (0.5, 0.9):
    the loss and Genh within 1e-5, every parameter (and u, v) within 1e-4 after it."""
    kw = dict(TOY, aewsegan=True, opt="adam", reg_loss=reg_loss, gnorm_type=gnorm)
    jseg = JaxAEWSEGAN(JaxConfig(**kw, save_path=str(tmp_path)))
    jseg.init_state(jax.random.PRNGKey(0), batch_size=4)
    flat = snorm_randomize({"params": jseg.state.g_params, **jseg.state.g_vars}, seed=8)
    tree = unflatten_tree(flat)
    jseg.state = jseg.state.replace(
        g_params=tree["params"], g_vars={k: v for k, v in tree.items() if k != "params"})
    jseg.prepare_train(4)
    rng = np.random.RandomState(9)
    clean = (rng.randn(4, 1024, 1) * 0.1).astype(np.float32)
    noisy = clean + (rng.randn(4, 1024, 1) * 0.02).astype(np.float32)
    mask = np.array([1, 1, 1, 0], np.float32)
    metrics, genh_j, z = jseg.train_step(clean, noisy, mask, jax.random.PRNGKey(3), 100.0)
    end = generator_state_from_jax(flatten_tree({"params": jseg.state.g_params,
                                                 **jseg.state.g_vars}))
    G = build_generator(SEGANConfig(**kw))
    G.load_state_dict(generator_state_from_jax(flat), strict=True)
    seg = AEWSEGAN(SEGANConfig(**kw), generator=G, device="cpu")
    assert seg.D is None and seg.use_l1 == (reg_loss == "l1_loss")
    assert seg.cfg.deconv_impl == "edge-blocked"
    got, genh, _ = seg.train_step(clean, noisy, mask, 100.0, z=np.asarray(z))
    assert abs(float(got["loss"]) - float(metrics["loss"])) <= TOL * float(metrics["loss"])
    assert _rel(genh.numpy(), genh_j) <= TOL
    for k, v in seg.G.state_dict().items():
        err = float((v.double() - end[k].double()).norm() / end[k].double().norm())
        assert err <= 1e-4, (k, err)
    groups = seg.g_opt.param_groups
    assert len(groups) == 1 and groups[0]["betas"] == (0.5, 0.9)


def test_evaluate_sd_matches_jax(tmp_path):
    """The spectral distortion of G's output on the first batch (no z, so the two
    engines' z streams do not enter)."""
    kw = dict(TOY, aewsegan=True, no_z=True)
    jseg = JaxAEWSEGAN(JaxConfig(**kw, save_path=str(tmp_path)))
    jseg.init_state(jax.random.PRNGKey(0), batch_size=2)
    flat = snorm_randomize({"params": jseg.state.g_params, **jseg.state.g_vars}, seed=10)
    tree = unflatten_tree(flat)
    jseg.state = jseg.state.replace(g_params=tree["params"],
                                    g_vars={"spectral": tree["spectral"]})
    G = build_generator(SEGANConfig(**kw))
    G.load_state_dict(generator_state_from_jax(flat), strict=True)
    seg = AEWSEGAN(SEGANConfig(**kw), generator=G, device="cpu")
    rng = np.random.RandomState(11)
    batches = [{"clean": (rng.randn(3, 4096) * 0.1).astype(np.float32),
                "noisy": (rng.randn(3, 4096) * 0.1).astype(np.float32)} for _ in range(2)]
    want = jseg.evaluate_sd(jseg.cfg, batches)
    got = seg.evaluate_sd(seg.cfg, batches)
    assert abs(got - want) <= 1e-4 * abs(want) and got > 0
    assert seg.evaluate_sd(seg.cfg, batches, max_samples=2) != got
