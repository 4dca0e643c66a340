"""D's SincConv front end (``--sinc_conv``) in the port against the JAX package at toy
width (slice 1024, denc_fmaps [8, 16, 32]: a bank of 4 filters shared by both channels,
then two blocks, 8 -> 16 -> 32 at stride 4, so dpool_slen 64): the forward in train and
eval, the phase draws per block, the bridge of 'filt_b1' and 'filt_band', one SEGAN+ and
one WSEGAN step, and the CLI of ``segan_pytorch_tpu_torch.train`` (its ``main``) with
``--sinc_conv`` and with ``--gnorm_type bnorm`` on the CPU, then ``clean``'s of the bnorm
checkpoint.

Weights come from ``test_torch_discriminator.randomize`` (and spectral norm's u, v from
``snorm_randomize``); the filters keep their mel-spaced band edges, each moved by a few
per cent. Tolerances: TOL (1e-5, relative to the largest JAX value) for one forward and
``tests/test_torch_train.py``'s STEP_TOL for a step's losses; the state after a step
within ``tests/test_torch_wsegan_step.py``'s STATE_TOL (1e-4, each tensor in L2).
"""
import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models import discriminator as jdisc
from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.models.wsegan import WSEGAN as JaxWSEGAN
from segan_pytorch_tpu.utils.checkpoint import (flatten_tree, load_torch_discriminator,
                                                unflatten_tree)
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models import modules as tmod
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
from segan_pytorch_tpu_torch.utils.checkpoint import (discriminator_state_from_jax,
                                                      generator_state_from_jax,
                                                      save_discriminator)
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import write_pairs
from test_torch_discriminator import randomize, record_phase
from test_torch_loop import LOG_LINE, TOY_ARGS
from test_torch_train import STEP_TOL, batch
from test_torch_wsegan_models import snorm_randomize
from test_torch_wsegan_step import STATE_TOL, batch as ws_batch, jax_draws, port_step

TOL = 1e-5
KEY = jax.random.PRNGKey(0)
TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
           z_dim=32, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=64,
           sinc_conv=True, no_bias=True)
WS_TOY = dict(TOY, wsegan=True, gnorm_type="snorm", dnorm_type="snorm", opt="adam",
              misalign_pair=True, no_bias=False)
B, L1 = 4, 100.0


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _randomize(variables, seed, snorm=False):
    """Weights at O(1) (u, v near the top singular pair with snorm); the filters' band
    edges moved by U(0.95, 1.05) from their mel init."""
    init = flatten_tree(variables)
    flat = (snorm_randomize if snorm else randomize)(variables, seed)
    rng = np.random.RandomState(seed + 200)
    for k in flat:
        if k.endswith(("filt_b1", "filt_band")):
            flat[k] = (np.asarray(init[k]) * rng.uniform(0.95, 1.05, init[k].shape)
                       ).astype(np.float32)
    return flat


def _jax_d(seed, **kw):
    cfg = JaxConfig(**dict(TOY, **kw))
    D = jdisc.build_discriminator(cfg)
    v = D.init({"params": KEY, "phase": KEY}, jnp.zeros((1, 1024, 2)), train=True)
    return D, _randomize(dict(v), seed, snorm=cfg.dnorm_type == "snorm")


def _port_d(flat, **kw):
    cfg = SEGANConfig(**dict(TOY, **kw))
    D = build_discriminator(cfg)
    D.load_state_dict(discriminator_state_from_jax(flat, cfg.dpool_slen,
                                                   cfg.denc_fmaps[-1]), strict=True)
    return D


def _pair(B_, seed):
    return (np.random.RandomState(seed).randn(B_, 1024, 2) * 0.5).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


@pytest.mark.parametrize("norm,train", [("bnorm", True), ("bnorm", False),
                                        ("snorm", True), ("snorm", False)])
def test_sinc_d_matches_jax(norm, train, monkeypatch):
    """The shared bank, the two blocks after it (rolled by the JAX D's own draws) and the
    'none' head; train mode with a masked row, the running statistics or u and v after."""
    D, flat = _jax_d(seed=1, dnorm_type=norm)
    draws = record_phase(monkeypatch)
    x = _pair(3, seed=2)
    mask = np.array([1, 1, 0], np.float32)
    mut = ["batch_stats", "spectral"]
    if train:
        (y_j, act_j), new = D.apply(unflatten_tree(flat), jnp.asarray(x), train=True,
                                    mask=jnp.asarray(mask), mutable=mut,
                                    rngs={"phase": KEY})
    else:
        y_j, act_j = D.apply(unflatten_tree(flat), jnp.asarray(x), train=False,
                             rngs={"phase": KEY})
    jax.effects_barrier()
    assert len(draws) == 2
    td = _port_d(flat, dnorm_type=norm).train(train)
    with torch.no_grad():
        y, act = td(_t(x), mask=torch.from_numpy(mask) if train else None,
                    phase=np.array(draws))
    assert _rel(y.numpy(), y_j) <= TOL
    for i in range(2):
        assert _rel(act[f"h_{i}"].numpy().transpose(0, 2, 1), act_j[f"h_{i}"]) <= TOL, i
    if train:
        want = discriminator_state_from_jax(
            {**flatten_tree(new), **{k: v for k, v in flat.items()
                                     if k.startswith("params/")}}, 64, 32)
        for k, v in td.state_dict().items():
            if k.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
                assert _rel(v.numpy(), want[k].numpy()) <= TOL, k


def test_phase_draws_follow_the_blocks():
    """One (shift, right) draw per block, none for the bank: two at toy width, four for
    a default D with the front end."""
    toy = build_discriminator(SEGANConfig(**TOY, phase_shift=5))
    assert toy.sample_phase(torch.Generator().manual_seed(0), passes=3).shape == (3, 2, 2)
    full = build_discriminator(SEGANConfig(sinc_conv=True, dpool_slen=64, phase_shift=5))
    assert len(full.enc_blocks) == 4
    assert full.sample_phase(torch.Generator().manual_seed(0)).shape == (4, 2)
    # at 16384 samples the four stride-4 blocks leave 64 for the 'none' head
    with torch.no_grad():
        y, act = full.eval()(torch.zeros(1, 2, 16384))
    assert act["h_3"].shape == (1, 1024, 64) and y.shape == (1, 1)


def test_bridge_of_the_filter_bank(tmp_path):
    """'params/sinc_conv/filt_b1' and 'filt_band' land on 'sinc_conv.filt_b1' and
    'sinc_conv.filt_band' unchanged. Back to JAX: ``load_torch_discriminator`` has no
    case for them (the JAX package drops the filters, ROADMAP.md queue C), so the port's
    filters join its output by hand and the JAX forward then equals the port's."""
    D, flat = _jax_d(seed=3)
    sd = discriminator_state_from_jax(flat, 64, 32)
    for name in ("filt_b1", "filt_band"):
        np.testing.assert_array_equal(sd[f"sinc_conv.{name}"].numpy(),
                                      flat[f"params/sinc_conv/{name}"])
    td = _port_d(flat)
    with torch.no_grad():
        td.sinc_conv.filt_b1.mul_(1.01)
    ckpt = str(tmp_path / "d.ckpt")
    save_discriminator(td, ckpt)
    tree = load_torch_discriminator(ckpt, 64, 32)
    assert "sinc_conv" not in tree["params"]
    tree["params"]["sinc_conv"] = {n: td.sinc_conv.get_parameter(n).detach().numpy()
                                   for n in ("filt_b1", "filt_band")}
    x = _pair(2, seed=4)
    y_j, _ = D.apply(tree, jnp.asarray(x), train=False)
    with torch.no_grad():
        y, _ = td.eval()(_t(x))
    assert _rel(y.numpy(), y_j) <= TOL


def _engine(cls, cfg, g_sd, d_sd):
    c = SEGANConfig(**cfg)
    G, D = build_generator(c), build_discriminator(c)
    G.load_state_dict(g_sd, strict=True)
    D.load_state_dict(d_sd, strict=True)
    return cls(c, generator=G, discriminator=D, device="cpu")


def _state_errs(seg, end, skip=()):
    errs = {}
    for side, want in zip(("G", "D"), end):
        sd = getattr(seg, side).state_dict()
        assert set(sd) == set(want)
        for k, v in sd.items():
            if not k.endswith("num_batches_tracked") and k not in skip:
                errs[f"{side}.{k}"] = float((v.double() - want[k].double()).norm()
                                            / want[k].double().norm())
    return errs


def _jax_step(cls, cfg, snorm, tmp_path, step_args):
    """One JAX step from randomised variables: (start and end in the port's names, the
    step's metrics, Genh, z and phase draws, its key)."""
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        jseg = cls(JaxConfig(**cfg, save_path=str(tmp_path)))
        jseg.init_state(KEY, batch_size=B)
        st = jseg.state
        g_flat = (snorm_randomize if snorm else randomize)(
            {"params": st.g_params, **st.g_vars}, seed=11)
        d_flat = _randomize({"params": st.d_params, **st.d_vars}, seed=12, snorm=snorm)
        g_tree, d_tree = unflatten_tree(g_flat), unflatten_tree(d_flat)
        jseg.state = st.replace(
            g_params=jax.device_put(g_tree["params"]),
            g_vars=jax.device_put({k: v for k, v in g_tree.items() if k != "params"}),
            d_params=jax.device_put(d_tree["params"]),
            d_vars=jax.device_put({k: v for k, v in d_tree.items() if k != "params"}))
        jseg.prepare_train(B)
        key = jax.random.PRNGKey(60)
        draws.clear()
        metrics, genh, z = jseg.train_step(*step_args, key, L1)
        jax.effects_barrier()
        st = jseg.state
        g_end = flatten_tree({"params": st.g_params, **st.g_vars})
        d_end = flatten_tree({"params": st.d_params, **st.d_vars})
    state = lambda g, d: (generator_state_from_jax(g),
                          discriminator_state_from_jax(d, 64, 32))
    return (state(g_flat, d_flat), state(g_end, d_end),
            {k: float(v) for k, v in metrics.items()}, np.asarray(genh), np.asarray(z),
            np.array(draws), key)


def test_segan_step_with_the_sinc_d_matches_jax(tmp_path):
    """One SEGAN+ step: the losses and Genh within STEP_TOL; then every tensor of G and D,
    the filters' band edges and the running statistics included, within STATE_TOL, but
    D's conv biases that feed a BatchNorm and the running means that take them in."""
    clean, noisy, mask = batch(3)  # its last row masked
    start, end, want, genh, z, draws, _ = _jax_step(JaxSEGAN, TOY, False, tmp_path,
                                                    (clean, noisy, mask))
    seg = _engine(SEGAN, TOY, *start)
    m, genh_t, _ = seg.train_step(clean, noisy, mask, L1, z=z,
                                  phase=draws.reshape(3, 2, 2))
    errs = {k: abs(float(m[k]) - v) / abs(v) for k, v in want.items()}
    errs["Genh"] = _rel(genh_t.numpy(), genh)
    assert all(e <= STEP_TOL for e in errs.values()), errs
    skip = {f"enc_blocks.{i}.{leaf}" for i in range(2)
            for leaf in ("conv.bias", "norm.running_mean")}
    errs = _state_errs(seg, end, skip)
    assert "D.sinc_conv.filt_band" in errs
    bad = {k: e for k, e in errs.items() if not e <= STATE_TOL}
    assert not bad, bad
    assert not torch.equal(seg.D.sinc_conv.filt_b1, start[1]["sinc_conv.filt_b1"])


def test_wsegan_step_with_the_sinc_d_matches_jax(tmp_path):
    """One WSEGAN step (scripts/run_wsegan_train.sh's flags: snorm G and D, Adam, the
    misaligned pair, biases) with the front end: the losses and Genh within STEP_TOL,
    every tensor, u and v within STATE_TOL after it."""
    clean, noisy = ws_batch(0)
    mask, amask = np.array([1, 1, 1, 0], np.float32), np.array([0, 1, 0, 1], np.float32)
    start, end, want, genh, z, draws, key = _jax_step(JaxWSEGAN, WS_TOY, True, tmp_path,
                                                      (clean, noisy, mask, amask))
    perm, squares = jax_draws(key)
    seg = _engine(WSEGAN, WS_TOY, *start)
    ref = dict(z=z, perm=perm, squares=squares, phase=draws.reshape(4, 2, 2))
    got, genh_t = port_step(seg, 0, ref, mask, amask)
    errs = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()}
    errs["Genh"] = _rel(genh_t.numpy(), genh)
    assert all(e <= STEP_TOL for e in errs.values()), errs
    errs = _state_errs(seg, end)
    assert "D.sinc_conv.filt_b1" in errs and "D.enc_blocks.1.conv.weight_u" in errs
    bad = {k: e for k, e in errs.items() if not e <= STATE_TOL}
    assert not bad, bad


# -- the training CLI ------------------------------------------------------------------------
def test_train_cli_runs_both_model_options_and_cleans_the_bnorm_g(tmp_path):
    """``train --sinc_conv`` (one block after the bank at TOY_ARGS' width, so dpool_slen
    4096 / 4 = 1024) and ``train --gnorm_type bnorm``, each one epoch of two batches on
    the CPU through the CLI's ``main`` in this process; then ``clean`` of the bnorm run's
    EOE checkpoint, whose train.opts says bnorm."""
    from scipy.io import wavfile

    from segan_pytorch_tpu_torch import clean as tclean
    from segan_pytorch_tpu_torch import train as ttrain

    clean_dir, noisy_dir = write_pairs(tmp_path / "corpus", [12000, 9000])
    saves = {}
    for name, extra in (("sinc", ["--sinc_conv", "--dpool_slen", "1024"]),
                        ("bnorm", ["--gnorm_type", "bnorm"])):
        saves[name] = str(tmp_path / name)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ttrain.main(["--save_path", saves[name], "--clean_trainset", clean_dir,
                         "--noisy_trainset", noisy_dir, "--cache_dir",
                         str(tmp_path / f"cache_{name}"), "--epoch", "1", "--device",
                         "cpu"] + TOY_ARGS + extra)
        lines = LOG_LINE.findall(out.getvalue())
        assert lines and lines[-1].startswith("(Iter 2) Batch 2/2 (Epoch 1)"), (
            name, out.getvalue()[-2000:])
    sinc_save, bn_save = saves["sinc"], saves["bnorm"]
    assert json.loads(Path(sinc_save, "train.opts").read_text())["sinc_conv"] is True
    d_idx = json.loads(Path(sinc_save, "EOE_D-checkpoints").read_text())
    d_sd = torch.load(os.path.join(sinc_save, "weights_" + d_idx["current"]),
                      weights_only=True)["state_dict"]
    assert {"sinc_conv.filt_b1", "sinc_conv.filt_band"} <= set(d_sd)
    opts = os.path.join(bn_save, "train.opts")
    assert json.loads(Path(opts).read_text())["gnorm_type"] == "bnorm"
    g_idx = json.loads(Path(bn_save, "EOE_G-checkpoints").read_text())
    g_ckpt = os.path.join(bn_save, "weights_" + g_idx["current"])
    g_sd = torch.load(g_ckpt, weights_only=True)["state_dict"]
    assert int(g_sd["enc_blocks.0.norm.num_batches_tracked"]) == 2
    synth = tmp_path / "synth"
    synth.mkdir()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tclean.main(tclean.build_parser().parse_args([
            "--g_pretrained_ckpt", g_ckpt, "--cfg_file", opts, "--test_files", noisy_dir,
            "--synthesis_path", str(synth), "--device", "cpu"]))
    assert "Cleaned 2/2" in out.getvalue()
    rate, wav = wavfile.read(str(synth / "utt1.wav"))
    assert rate == 16000 and wav.shape == (9000,) and np.all(np.isfinite(wav))
    assert isinstance(build_generator(SEGANConfig(gnorm_type="bnorm")).enc_blocks[0].norm,
                      tmod.BatchNorm1d)
