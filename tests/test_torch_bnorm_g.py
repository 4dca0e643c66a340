"""A bnorm generator (``--gnorm_type bnorm``) in the port against the JAX package at toy
width (slice 1024, fmaps 8/16/32, z_dim 32, --no_bias): the forward in train and eval,
the checkpoint bridge both ways with the running statistics ('batch_stats'), the SEGAN+
step over several steps, one WSEGAN step, the bf16 inference copy, the graphed
dispatch's eager path, and ``generate``.

Weights come from ``test_torch_discriminator.randomize`` (BatchNorm's scales and running
statistics away from their initial values). In the step, every decoder deconv's bias
feeds a BatchNorm, as D's conv biases do (``test_torch_train.py``): its true gradient is
0, and RMSprop turns the rounding noise left in it into ~10 lr steps, so those biases and
the running means that take them in are held apart, their gradients checked to be noise.
Tolerances are ``tests/test_torch_train.py``'s: STEP_TOL (1e-5) for one step and
TRAJ_TOL (1e-3) over several, each tensor's total change in L2.
"""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models.generator import build_generator as jax_build_g
from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.models.wsegan import WSEGAN as JaxWSEGAN
from segan_pytorch_tpu.utils.checkpoint import (export_torch_generator, flatten_tree,
                                                load_torch_generator, save_pytree,
                                                unflatten_tree)
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models import modules as tmod
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
from segan_pytorch_tpu_torch.utils.checkpoint import (discriminator_state_from_jax,
                                                      generator_state_from_jax,
                                                      load_generator, save_generator)
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_discriminator import randomize, record_phase
from test_torch_train import BIAS_BEFORE_BN, STEP_TOL, TRAJ_TOL, batch
from test_torch_wsegan_models import snorm_randomize
from test_torch_wsegan_step import batch as ws_batch, jax_draws, n_passes, port_step

G_TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4],
             gkwidth=31, z_dim=32, gnorm_type="bnorm", no_bias=True)
TOY = dict(G_TOY, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16)
B, STEPS, L1 = 4, 5, 100.0
KEY = jax.random.PRNGKey(0)
# the decoder deconvs' biases feed a BatchNorm (see the module docstring)
G_BIAS_BEFORE_BN = {f"dec_blocks.{i}.{leaf}" for i in range(3)
                    for leaf in ("deconv.bias", "norm.running_mean")}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_g(seed):
    """The JAX bnorm G and its randomised variables ('params' and 'batch_stats')."""
    G = jax_build_g(JaxConfig(**G_TOY))
    v = G.init({"params": KEY, "z": KEY}, jnp.zeros((1, 1024, 1)), train=True)
    return G, randomize(dict(v), seed)


def _io(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 1024, 1).astype(np.float32) * 0.3,
            rng.randn(3, 16, 32).astype(np.float32))


def _port_g(flat):
    G = build_generator(SEGANConfig(**G_TOY))
    G.load_state_dict(generator_state_from_jax(flat), strict=True)
    return G


def test_bnorm_generator_has_a_norm_in_every_block():
    G = build_generator(SEGANConfig(**G_TOY))
    assert all(isinstance(b.norm, tmod.BatchNorm1d) for b in G.enc_blocks)
    assert all(isinstance(b.norm, tmod.BatchNorm1d) for b in G.dec_blocks)
    assert {k for k in G.state_dict() if "norm" in k} == {
        f"{g}.{i}.norm.{leaf}" for g in ("enc_blocks", "dec_blocks") for i in range(3)
        for leaf in ("weight", "bias", "running_mean", "running_var",
                     "num_batches_tracked")}


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(train):
    """Eval mode normalises with the running statistics; train mode with the batch's,
    and moves the running statistics of all six norms as the JAX G does."""
    G, flat = _jax_g(seed=1)
    x, z = _io(2)
    v = unflatten_tree(flat)
    if train:
        y_j, new = G.apply(v, jnp.asarray(x), z=jnp.asarray(z), train=True,
                           mutable=["batch_stats"])
    else:
        y_j = G.apply(v, jnp.asarray(x), z=jnp.asarray(z), train=False)
    tg = _port_g(flat).train(train)
    with torch.no_grad():
        y = tg(torch.from_numpy(x), torch.from_numpy(z))
    assert _rel(y.numpy(), y_j) <= 5e-5
    if train:
        want = generator_state_from_jax(flatten_tree({"batch_stats": new["batch_stats"]}))
        for k, w in want.items():
            assert _rel(tg.state_dict()[k].numpy(), w.numpy()) <= 1e-5, k
        assert int(tg.enc_blocks[0].norm.num_batches_tracked) == 1


def test_jax_export_loads_strictly_into_the_port(tmp_path):
    """``export_torch_generator`` writes 'norm.*' with the running statistics; the port
    loads it strictly and its eval forward equals the JAX one."""
    G, flat = _jax_g(seed=3)
    tree = unflatten_tree(flat)
    ckpt = str(tmp_path / "g.ckpt")
    export_torch_generator(tree, ckpt)
    tg = build_generator(SEGANConfig(**G_TOY))
    load_generator(tg, ckpt)
    torch.testing.assert_close(tg.dec_blocks[1].norm.running_var,
                               torch.from_numpy(flat["batch_stats/dec_blocks_1/norm/"
                                                     "running_var"]))
    x, z = _io(4)
    y_j = G.apply(tree, jnp.asarray(x), z=jnp.asarray(z), train=False)
    with torch.no_grad():
        y = tg.eval()(torch.from_numpy(x), torch.from_numpy(z))
    assert _rel(y.numpy(), y_j) <= 5e-5


def test_port_save_loads_into_jax(tmp_path):
    """The port's checkpoint through ``load_torch_generator``: the running statistics
    land in 'batch_stats', and the JAX eval forward equals the port's."""
    tg = _port_g(_jax_g(seed=5)[1])
    x, z = _io(6)
    with torch.no_grad():  # move the statistics away from those loaded
        tg.train()(torch.from_numpy(x), torch.from_numpy(z))
    ckpt = str(tmp_path / "g.ckpt")
    save_generator(tg, ckpt)
    tree = load_torch_generator(ckpt)
    np.testing.assert_array_equal(
        tree["batch_stats"]["enc_blocks_2"]["norm"]["running_mean"],
        tg.enc_blocks[2].norm.running_mean.numpy())
    G = jax_build_g(JaxConfig(**G_TOY))
    y_j = G.apply(tree, jnp.asarray(x), z=jnp.asarray(z), train=False)
    with torch.no_grad():
        y = tg.eval()(torch.from_numpy(x), torch.from_numpy(z))
    assert _rel(y.numpy(), y_j) <= 5e-5


def test_jax_trainer_npz_with_batch_stats_loads(tmp_path):
    G, flat = _jax_g(seed=7)
    tree = unflatten_tree(flat)
    path = str(tmp_path / "weights_EOE_G-Generator-3.npz")
    save_pytree(path, {"state_dict": tree}, meta={"step": 3})
    tg = build_generator(SEGANConfig(**G_TOY))
    load_generator(tg, path)
    x, z = _io(8)
    y_j = G.apply(tree, jnp.asarray(x), z=jnp.asarray(z), train=False)
    with torch.no_grad():
        y = tg.eval()(torch.from_numpy(x), torch.from_numpy(z))
    assert _rel(y.numpy(), y_j) <= 5e-5


# -- the SEGAN+ step --------------------------------------------------------------------
def _port_state(g_flat, d_flat, cfg=TOY):
    return (generator_state_from_jax(g_flat),
            discriminator_state_from_jax(d_flat, cfg["dpool_slen"], cfg["denc_fmaps"][-1]))


def _engine(cls, cfg, g_sd, d_sd, **kw):
    c = SEGANConfig(**cfg, **kw)
    G, D = build_generator(c), build_discriminator(c)
    G.load_state_dict(g_sd, strict=True)
    D.load_state_dict(d_sd, strict=True)
    return cls(c, generator=G, discriminator=D, device="cpu")


@pytest.fixture(scope="module")
def segan_run(tmp_path_factory):
    """STEPS JAX SEGAN+ steps with a bnorm G from randomised weights and statistics: per
    step the losses, Genh, z and phase draws; the state before and after."""
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        jseg = JaxSEGAN(JaxConfig(**TOY, save_path=str(tmp_path_factory.mktemp("j"))))
        jseg.init_state(KEY, batch_size=B)
        st = jseg.state
        assert set(st.g_vars) == {"batch_stats"}
        g_flat = randomize({"params": st.g_params, **st.g_vars}, seed=11)
        d_flat = randomize({"params": st.d_params, **st.d_vars}, seed=12)
        g_tree, d_tree = unflatten_tree(g_flat), unflatten_tree(d_flat)
        jseg.state = st.replace(
            g_params=jax.device_put(g_tree["params"]),
            g_vars=jax.device_put({"batch_stats": g_tree["batch_stats"]}),
            d_params=jax.device_put(d_tree["params"]),
            d_vars=jax.device_put({"batch_stats": d_tree["batch_stats"]}))
        jseg.prepare_train(B)
        steps = []
        for i in range(STEPS):
            draws.clear()
            metrics, genh, z = jseg.train_step(*batch(i), jax.random.PRNGKey(40 + i), L1)
            jax.effects_barrier()
            steps.append(dict({k: float(v) for k, v in metrics.items()},
                              genh=np.array(genh), z=np.array(z),
                              phase=np.array(draws).reshape(3, 3, 2)))
        st = jseg.state
        g_end = flatten_tree({"params": st.g_params, **st.g_vars})
        d_end = flatten_tree({"params": st.d_params, **st.d_vars})
    return _port_state(g_flat, d_flat), _port_state(g_end, d_end), steps


def _run_port(start, steps, **kw):
    seg = _engine(SEGAN, TOY, *start, **kw)
    out = []
    for i, ref in enumerate(steps):
        m, genh, _ = seg.train_step(*batch(i), L1, z=ref["z"], phase=ref["phase"])
        out.append(dict({k: float(v) for k, v in m.items()}, genh=genh.numpy()))
    return seg, out


def test_segan_step_matches_jax_with_running_statistics(segan_run):
    """One step within STEP_TOL (losses, Genh); five steps within TRAJ_TOL: the losses at
    every step, each tensor's total change, and G's running statistics, which move once
    a step, in the one G forward."""
    start, end, steps = segan_run
    seg, out = _run_port(start, steps)
    for k in ("d_real", "d_fake", "g_adv", "g_l1"):
        assert abs(out[0][k] - steps[0][k]) <= STEP_TOL * abs(steps[0][k]), k
    assert _rel(out[0]["genh"], steps[0]["genh"]) <= STEP_TOL
    for i, (got, want) in enumerate(zip(out, steps)):
        for k in ("d_real", "d_fake", "g_adv", "g_l1"):
            assert abs(got[k] - want[k]) <= TRAJ_TOL * abs(want[k]), (i, k)
    errs = {}
    skip = {"G": G_BIAS_BEFORE_BN, "D": BIAS_BEFORE_BN}
    for side, s0, s1 in (("G", start[0], end[0]), ("D", start[1], end[1])):
        sd = getattr(seg, side).state_dict()
        assert set(sd) == set(s1)
        for name, v in sd.items():
            if name.endswith("num_batches_tracked") or name in skip[side]:
                continue
            want, got = (s1[name] - s0[name]).double(), (v - s0[name]).double()
            if name.endswith(("running_mean", "running_var")):
                want, got = s1[name].double(), v.double()
            assert float(want.norm()) > 0, name
            errs[f"{side}.{name}"] = float((got - want).norm() / want.norm())
    assert "G.enc_blocks.0.norm.running_var" in errs
    bad = {k: e for k, e in errs.items() if not e <= TRAJ_TOL}
    assert not bad, bad
    assert int(seg.G.enc_blocks[0].norm.num_batches_tracked) == STEPS
    for i, blk in enumerate(seg.G.dec_blocks):  # the deconv biases that feed a norm
        ratio = float(blk.deconv.bias.grad.norm() / blk.norm.bias.grad.norm())
        assert ratio <= 1e-4, (i, ratio)


def test_bf16_copy_carries_the_last_steps_statistics(segan_run):
    """A bf16 engine's inference copy, built before a step, is rebuilt after it with G's
    new running statistics (fp32 buffers): equal to a fresh cast copy of G."""
    start, _, steps = segan_run
    seg = _engine(SEGAN, TOY, *start, compute_dtype="bfloat16")
    x = torch.from_numpy(batch(3)[1])
    z = steps[0]["z"]
    before = seg.infer_G(x, z)
    stats = seg.G.enc_blocks[1].norm.running_mean.clone()
    seg.train_step(*batch(0), L1, z=z, phase=steps[0]["phase"])
    assert not torch.equal(stats, seg.G.enc_blocks[1].norm.running_mean)
    assert seg.G.enc_blocks[1].norm.running_mean.dtype == torch.float32
    copy_g = seg._g()
    assert copy_g.enc_blocks[1].norm.running_mean.dtype == torch.float32
    torch.testing.assert_close(copy_g.enc_blocks[1].norm.running_mean,
                               seg.G.enc_blocks[1].norm.running_mean, rtol=0, atol=0)
    fresh = copy.deepcopy(seg.G)
    for p in fresh.parameters():
        p.data = p.data.bfloat16()
    with torch.no_grad():
        want = fresh.eval()(x.bfloat16(), torch.from_numpy(z).bfloat16()).float()
    got = seg.infer_G(x, z)
    torch.testing.assert_close(got, want)
    assert not torch.equal(got, before)


def test_multi_step_eager_path_moves_g_statistics_as_single_steps():
    """``train_step_multi`` (on the CPU the graph's body, eagerly) against single steps:
    every parameter and buffer, G's running statistics included, bit for bit."""
    cfg = SEGANConfig(**TOY, seed=3)
    multi, single = SEGAN(cfg, device="cpu"), SEGAN(cfg, device="cpu")
    bs = [batch(i) for i in range(3)]
    clean, noisy, mask = (np.stack([b[j] for b in bs]) for j in range(3))
    multi.train_step_multi(clean, noisy, mask, l1_w_s=[L1] * 3)
    for i in range(3):
        single.train_step(*bs[i], L1)
    for side in ("G", "D"):
        a, b = getattr(multi, side).state_dict(), getattr(single, side).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (side, k)
    assert int(multi.G.dec_blocks[2].norm.num_batches_tracked) == 3


# -- WSEGAN ------------------------------------------------------------------------------
WS_TOY = dict(TOY, wsegan=True, dnorm_type="snorm", opt="adam", misalign_pair=True,
              no_bias=False)


def test_wsegan_step_with_a_bnorm_generator_matches_jax(tmp_path):
    """One WSEGAN step (snorm D, Adam, the misaligned pair, biases) with a bnorm G: the
    losses and Genh within STEP_TOL; G's parameters and running statistics, D's
    parameters, u and v within 1e-4 (``test_torch_wsegan_step.py``'s STATE_TOL) after it,
    but G's biases that feed a BatchNorm and the running means that take them in."""
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        jseg = JaxWSEGAN(JaxConfig(**WS_TOY, save_path=str(tmp_path)))
        jseg.init_state(KEY, batch_size=B)
        st = jseg.state
        assert set(st.g_vars) == {"batch_stats"}
        g_flat = randomize({"params": st.g_params, **st.g_vars}, seed=21)
        d_flat = snorm_randomize({"params": st.d_params, **st.d_vars}, seed=22)
        g_tree, d_tree = unflatten_tree(g_flat), unflatten_tree(d_flat)
        jseg.state = st.replace(
            g_params=jax.device_put(g_tree["params"]),
            g_vars=jax.device_put({"batch_stats": g_tree["batch_stats"]}),
            d_params=jax.device_put(d_tree["params"]),
            d_vars=jax.device_put({"spectral": d_tree["spectral"]}))
        jseg.prepare_train(B)
        mask, amask = [1, 1, 1, 0], [0, 1, 0, 1]
        key = jax.random.PRNGKey(50)
        clean, noisy = ws_batch(0)
        draws.clear()
        metrics, genh, z = jseg.train_step(clean, noisy, np.asarray(mask, np.float32),
                                           np.asarray(amask, np.float32), key, L1)
        jax.effects_barrier()
        perm, squares = jax_draws(key)
        ref = dict(z=np.array(z), perm=perm, squares=squares,
                   phase=np.array(draws).reshape(n_passes(WS_TOY), 3, 2))
        st = jseg.state
        g_end = flatten_tree({"params": st.g_params, **st.g_vars})
        d_end = flatten_tree({"params": st.d_params, **st.d_vars})
    seg = _engine(WSEGAN, WS_TOY, *_port_state(g_flat, d_flat))
    got, genh_t = port_step(seg, 0, ref, mask, amask)
    loss_errs = {k: abs(got[k] - float(v)) / max(abs(float(v)), 1e-12)
                 for k, v in metrics.items()}
    loss_errs["Genh"] = _rel(genh_t.numpy(), genh)
    assert all(e <= STEP_TOL for e in loss_errs.values()), loss_errs
    errs = {}
    # with biases, the encoder's conv biases feed a BatchNorm too; Adam's first step
    # moves each of these noise-driven biases by lr
    skip = G_BIAS_BEFORE_BN | {f"enc_blocks.{i}.{leaf}" for i in range(3)
                               for leaf in ("conv.bias", "norm.running_mean")}
    for side, want in zip(("G", "D"), _port_state(g_end, d_end)):
        sd = getattr(seg, side).state_dict()
        assert set(sd) == set(want)
        for k, v in sd.items():
            if not k.endswith("num_batches_tracked") and not (side == "G" and k in skip):
                errs[f"{side}.{k}"] = float((v.double() - want[k].double()).norm()
                                            / want[k].double().norm())
    assert "G.dec_blocks.0.norm.running_var" in errs
    bad = {k: e for k, e in errs.items() if not e <= 1e-4}
    assert not bad, bad


# -- enhancement ---------------------------------------------------------------------------
def test_generate_runs_g_in_eval_mode_on_the_running_statistics(tmp_path):
    """``generate`` of a bnorm G equals the JAX engine's with the same z, and leaves the
    running statistics as they were."""
    G, flat = _jax_g(seed=31)
    tree = unflatten_tree(flat)
    jseg = JaxSEGAN(JaxConfig(**TOY, save_path=str(tmp_path)))
    jseg.init_state(KEY, batch_size=1)
    jseg.state = jseg.state.replace(g_params=jax.device_put(tree["params"]),
                                    g_vars=jax.device_put({"batch_stats":
                                                           tree["batch_stats"]}))
    seg = SEGAN(SEGANConfig(**G_TOY), generator=_port_g(flat), device="cpu")
    wav = (np.random.RandomState(32).randn(2500) * 0.2).astype(np.float32)
    z = np.random.RandomState(33).randn(1, 16, 32).astype(np.float32)
    before = {k: v.clone() for k, v in seg.G.state_dict().items()}
    got, g_c = seg.generate(wav, z=z)
    want, want_c = jseg.generate(wav, z=z)
    assert got.shape == want.shape == (2500,)
    assert _rel(got, want) <= 5e-5 and _rel(g_c, np.asarray(want_c)) <= 5e-5
    for k, v in seg.G.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not seg.G.training


def test_serve_answers_and_reloads_bnorm_generations(tmp_path, monkeypatch):
    """``serve`` strict-loads a bnorm G's checkpoint (running statistics included) and
    answers with its eval-mode ``generate``; ``/admin/reload`` swaps in another bnorm
    generation (other statistics), whose answer is then the new engine's."""
    from segan_pytorch_tpu_torch import serve
    from test_torch_serve import (SELF_TOL, Server, _checkpoint, _prep, _seed_z,
                                  _wav_bytes)
    from test_torch_serve_reload import _answer, _engine, _reload

    monkeypatch.setattr(serve, "RETIRE_SECONDS", 0.2)
    made = {}
    for name, seed in (("A", 41), ("B", 42)):
        (tmp_path / name).mkdir()
        ckpt, opts, cfg = _checkpoint(tmp_path / name, gnorm_type="bnorm")
        sd = torch.load(str(ckpt), weights_only=False)
        g = torch.Generator().manual_seed(seed)
        for k, v in sd["state_dict"].items():  # statistics away from (0, 1)
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
        torch.save(sd, str(ckpt))
        made[name] = (ckpt, opts, cfg)
    (ckpt_a, opts, cfg), (ckpt_b, _, _) = made["A"], made["B"]
    s = Server(ckpt_a, opts)
    try:
        body = _wav_bytes(n=2500, seed=4)
        eng_a, eng_b = _engine(ckpt_a, cfg), _engine(ckpt_b, cfg)
        assert isinstance(eng_a.G.dec_blocks[0].norm, tmod.BatchNorm1d)
        want = {n: e.generate(_prep(body, cfg.preemph), z=_seed_z(e.G, 11))[0]
                for n, e in (("A", eng_a), ("B", eng_b))}
        np.testing.assert_allclose(_answer(s.base, body, 11), want["A"], rtol=SELF_TOL,
                                   atol=SELF_TOL)
        assert _reload(s.base, {"g_ckpt": str(ckpt_b)})["status"] == "reloaded"
        np.testing.assert_allclose(_answer(s.base, body, 11), want["B"], rtol=SELF_TOL,
                                   atol=SELF_TOL)
        assert np.abs(want["A"] - want["B"]).max() > 100 * SELF_TOL
    finally:
        s.stop()
