"""Several train steps per call (``train_step_multi``, ``models/multistep.py``) on the CPU,
at the toy width of ``tests/test_train.py``'s ``small_cfg`` (slice 1024, fmaps 8/16/32 in
G and D, z_dim 32, pool_slen 16).

- Against JAX: the port's two sub-steps equal the JAX package's ``train_step_multi`` (a
  ``lax.scan`` of two steps), with JAX's z, phase draws, permutation and square waves
  passed in, for SEGAN+, WSEGAN and AEWSEGAN (``TestMultiStepDispatch`` of
  ``tests/test_train.py`` holds the JAX scan to the JAX single steps).
- Against the port's own single step: S sub-steps equal S ``train_step`` calls bit for bit
  (losses, Genh, every parameter, buffer, gradient and optimizer state), with the draws
  from the same streams; the device-shift roll the step takes there equals ``torch.roll``
  and the JAX roll bit for bit.
- The optimizers a CUDA graph can replay: ``set_capturable`` and back, a capturable
  optimizer's state through the ``Saver`` into an eager engine; no silent CPU.
On a card ``chip_smoke.py`` phase 10 holds the graph itself; here the same body runs
eagerly.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.models.wsegan import AEWSEGAN as JaxAEWSEGAN, WSEGAN as JaxWSEGAN
from segan_pytorch_tpu.ops.roll import phase_shift_roll as jax_roll
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch import train as ttrain
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.multistep import set_capturable
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import AEWSEGAN, WSEGAN
from segan_pytorch_tpu_torch.ops.roll import phase_shift_roll
from segan_pytorch_tpu_torch.utils.checkpoint import Saver, generator_state_from_jax
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_discriminator import randomize, record_phase
from test_torch_train import BIAS_BEFORE_BN, STEP_TOL, TOY, port_engine, port_state
from test_torch_wsegan_models import snorm_randomize
import test_torch_wsegan_step as ws

B, T, S = 4, 1024, 2
L1S = [100.0, 99.5]
# every parameter, buffer and u, v after the two sub-steps, each tensor in relative L2, at
# the step's own bound; WSEGAN's at its single step's (test_torch_wsegan_step.STATE_TOL,
# 1e-4): after two Adam steps one deconv's weight_orig and v read 1.2e-5 here
STATE_TOL = STEP_TOL


def _stack(i0):
    """Two of test_torch_train's batches, stacked: (S, B, T, 1), (S, B, T, 1), (S, B); the
    second with its last row masked out."""
    rng = [np.random.RandomState(300 + i0 + i) for i in range(S)]
    clean = np.stack([(r.randn(B, T, 1) * 0.1).astype(np.float32) for r in rng])
    noisy = clean + np.stack([(r.randn(B, T, 1) * 0.02).astype(np.float32) for r in rng])
    mask = np.ones((S, B), np.float32)
    mask[1, -1] = 0.0
    return clean, noisy, mask


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def _state_errs(module, want, skip=(), tol=STATE_TOL):
    errs = {}
    for k, v in module.state_dict().items():
        if k in skip or k.endswith("num_batches_tracked"):
            continue
        w = want[k].double()
        errs[k] = float((v.double() - w).norm() / max(float(w.norm()), 1e-30))
    return {k: e for k, e in errs.items() if not e <= tol}


def _z_of(jgen, key, shape, splits):
    return np.asarray(jgen.sample_z(jax.random.split(key, splits)[0], shape))


def test_segan_multi_step_matches_jax(tmp_path):
    clean, noisy, mask = _stack(0)
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        jseg = JaxSEGAN(JaxConfig(**TOY, save_path=str(tmp_path)))
        jseg.init_state(jax.random.PRNGKey(0), batch_size=B)
        st = jseg.state
        g_flat = randomize({"params": st.g_params}, seed=1)
        d_flat = randomize({"params": st.d_params, **st.d_vars}, seed=2)
        g_tree, d_tree = unflatten_tree(g_flat), unflatten_tree(d_flat)
        jseg.state = st.replace(
            g_params=jax.device_put(g_tree["params"]),
            d_params=jax.device_put(d_tree["params"]),
            d_vars=jax.device_put({"batch_stats": d_tree["batch_stats"]}))
        jseg.prepare_train(B)
        jseg.prepare_multi_step(S)
        rng = jax.random.PRNGKey(42)
        draws.clear()
        jms, jlast, jgenh, jz = jseg.train_step_multi(clean, noisy, mask, rng=rng,
                                                      l1_w_s=L1S)
        jax.effects_barrier()
        phase = np.array(draws).reshape(S, 3, 3, 2)
    z = np.stack([_z_of(jseg.G, k, (B, T, 1), 5) for k in jax.random.split(rng, S)])
    np.testing.assert_array_equal(z[-1], np.asarray(jz))
    st = jseg.state
    g_end, d_end = port_state(flatten_tree({"params": st.g_params}),
                              flatten_tree({"params": st.d_params, **st.d_vars}))
    seg = port_engine(*port_state(g_flat, d_flat))
    ms, last, genh, z_last = seg.train_step_multi(clean, noisy, mask, l1_w_s=L1S, z=z,
                                                  phase=phase)
    assert seg.step == S and torch.equal(z_last, torch.from_numpy(z[-1]))
    for k in ("d_real", "d_fake", "g_adv", "g_l1"):
        for i in range(S):
            assert _rel(float(ms[k][i]), float(jms[k][i])) <= STEP_TOL, (k, i)
        assert float(last[k]) == float(ms[k][-1])
    np.testing.assert_allclose(genh.numpy(), np.asarray(jgenh), rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert not _state_errs(seg.G, g_end)
    skip = BIAS_BEFORE_BN | {f"enc_blocks.{i}.norm.running_mean" for i in range(3)}
    assert not _state_errs(seg.D, d_end, skip)


def test_wsegan_multi_step_matches_jax(tmp_path):
    """run_wsegan_train.sh's flags with the interfered pair too, and 'additive' rows."""
    kw = dict(interf_pair=True)
    cfg = dict(ws.TOY, **kw)
    clean, noisy, mask = _stack(10)
    amask = np.tile(np.array([0, 1, 0, 1], np.float32), (S, 1))
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        jseg = JaxWSEGAN(JaxConfig(**cfg, save_path=str(tmp_path)))
        jseg.init_state(jax.random.PRNGKey(0), batch_size=B)
        st = jseg.state
        g_flat = snorm_randomize({"params": st.g_params, **st.g_vars}, seed=1)
        d_flat = snorm_randomize({"params": st.d_params, **st.d_vars}, seed=2)
        g_tree, d_tree = unflatten_tree(g_flat), unflatten_tree(d_flat)
        jseg.state = st.replace(
            g_params=jax.device_put(g_tree["params"]),
            g_vars=jax.device_put({"spectral": g_tree["spectral"]}),
            d_params=jax.device_put(d_tree["params"]),
            d_vars=jax.device_put({"spectral": d_tree["spectral"]}))
        jseg.prepare_train(B)
        jseg.prepare_multi_step(S)
        rng = jax.random.PRNGKey(43)
        draws.clear()
        jms, jlast, jgenh, jz = jseg.train_step_multi(clean, noisy, mask, amask, rng=rng,
                                                      l1_w_s=[100.0] * S)
        jax.effects_barrier()
        phase = np.array(draws).reshape(S, ws.n_passes(cfg), 3, 2)
    keys = jax.random.split(rng, S)
    z = np.stack([_z_of(jseg.G, k, (B, T, 1), 9) for k in keys])
    perm, squares = (np.stack(v) for v in zip(*(ws.jax_draws(k) for k in keys)))
    np.testing.assert_array_equal(z[-1], np.asarray(jz))
    st = jseg.state
    g_end, d_end = ws.port_state(flatten_tree({"params": st.g_params, **st.g_vars}),
                                 flatten_tree({"params": st.d_params, **st.d_vars}))
    seg = ws.port_engine(*ws.port_state(g_flat, d_flat), **kw)
    ms, last, genh, _ = seg.train_step_multi(clean, noisy, mask, amask, l1_w_s=[100.0] * S,
                                             z=z, phase=phase, perm=perm, squares=squares)
    assert set(ms) == set(jms) and len(ms) == 9
    for k in ms:
        for i in range(S):
            assert _rel(float(ms[k][i]), float(jms[k][i])) <= STEP_TOL, (k, i)
    assert float(ms["den_loss"][-1]) > 0
    np.testing.assert_allclose(genh.numpy(), np.asarray(jgenh), rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert not _state_errs(seg.G, g_end, tol=ws.STATE_TOL)
    assert not _state_errs(seg.D, d_end, tol=ws.STATE_TOL)


def test_aewsegan_multi_step_matches_jax(tmp_path):
    kw = dict(TOY, aewsegan=True, opt="adam", gnorm_type="snorm")
    clean, noisy, mask = _stack(20)
    jseg = JaxAEWSEGAN(JaxConfig(**kw, save_path=str(tmp_path)))
    jseg.init_state(jax.random.PRNGKey(0), batch_size=B)
    flat = snorm_randomize({"params": jseg.state.g_params, **jseg.state.g_vars}, seed=8)
    tree = unflatten_tree(flat)
    jseg.state = jseg.state.replace(
        g_params=tree["params"], g_vars={k: v for k, v in tree.items() if k != "params"})
    jseg.prepare_train(B)
    jseg.prepare_multi_step(S)
    rng = jax.random.PRNGKey(44)
    jms, _, jgenh, jz = jseg.train_step_multi(clean, noisy, mask, rng=rng,
                                              l1_w_s=[100.0] * S)
    z = np.stack([_z_of(jseg.G, k, (B, T, 1), 2) for k in jax.random.split(rng, S)])
    np.testing.assert_array_equal(z[-1], np.asarray(jz))
    end = generator_state_from_jax(flatten_tree({"params": jseg.state.g_params,
                                                 **jseg.state.g_vars}))
    G = build_generator(SEGANConfig(**kw))
    G.load_state_dict(generator_state_from_jax(flat), strict=True)
    seg = AEWSEGAN(SEGANConfig(**kw), generator=G, device="cpu")
    ms, _, genh, _ = seg.train_step_multi(clean, noisy, mask, l1_w_s=[100.0] * S, z=z)
    for i in range(S):
        assert _rel(float(ms["loss"][i]), float(jms["loss"][i])) <= STEP_TOL, i
    np.testing.assert_allclose(genh.numpy(), np.asarray(jgenh), rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert not _state_errs(seg.G, end)


ENGINES = {
    "segan": (SEGAN, dict(no_bias=True)),
    "wsegan": (WSEGAN, dict(wsegan=True, gnorm_type="snorm", dnorm_type="snorm",
                            opt="adam", misalign_pair=True, interf_pair=True)),
    "aewsegan": (AEWSEGAN, dict(aewsegan=True, opt="adam")),
}


def _engine(kind, seed=3, **kw):
    cls, flags = ENGINES[kind]
    return cls(SEGANConfig(**{**TOY, **flags, **kw}, seed=seed), device="cpu")


def _everything(seg):
    """Every tensor of an engine's state: parameters, their gradients, buffers and the
    optimizers' state, by name."""
    out = {}
    for side, opt in (("G", seg.g_opt), ("D", seg.d_opt)):
        m = getattr(seg, side)
        if m is None:
            continue
        for n, p in m.named_parameters():
            out[f"{side}.{n}"] = p
            out[f"{side}.{n}.grad"] = p.grad
        out.update({f"{side}.{n}": b for n, b in m.named_buffers()})
        names = {id(p): n for n, p in m.named_parameters()}
        for p, st in opt.state.items():
            out.update({f"{side}.{names[id(p)]}.{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_sub_steps_equal_single_steps_bit_for_bit(kind, dtype):
    """Three sub-steps against three train_step calls of an engine with the same seed:
    every draw from the same streams, everything equal bit for bit."""
    multi, single = _engine(kind, compute_dtype=dtype), _engine(kind, compute_dtype=dtype)
    clean, noisy, mask = (np.concatenate([a, a[:1]]) for a in _stack(30))
    l1s = [100.0, 99.99, 99.98]
    extra = [np.tile(np.array([1, 0, 0, 1], np.float32), (3, 1))] if kind == "wsegan" else []
    ms, last, genh, z = multi.train_step_multi(clean, noisy, mask, *extra, l1_w_s=l1s)
    for i in range(3):
        m, g, zi = single.train_step(clean[i], noisy[i], mask[i],
                                     *[e[i] for e in extra], l1s[i])
        for k in m:
            assert torch.equal(ms[k][i], m[k]), (k, i)
    assert torch.equal(genh, g) and (z is None and zi is None or torch.equal(z, zi))
    assert last.keys() == m.keys() and all(torch.equal(last[k], m[k]) for k in m)
    a, b = _everything(multi), _everything(single)
    assert a.keys() == b.keys() and len(a) > 10
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert multi.step == single.step == 3


def test_draws_follow_the_streams_and_given_ones_win():
    """Draws not given come from the engine's streams in the single step's order; given
    ones are used as they are and draw nothing."""
    a, b = _engine("segan"), _engine("segan")
    clean, noisy, mask = _stack(40)
    phase = np.ones((S, 3, 3, 2), np.int64)
    a.train_step_multi(clean, noisy, mask, l1_w_s=L1S, phase=phase)
    b.train_step(clean[0], noisy[0], mask[0], L1S[0], phase=phase[0])
    b.train_step(clean[1], noisy[1], mask[1], L1S[1], phase=phase[1])
    assert all(torch.equal(x, y) for x, y in zip(a._parameters(), b._parameters()))
    assert torch.equal(a._phase_train.get_state(), torch.Generator().manual_seed(
        a.seed + 4).get_state())  # no phase drawn
    with pytest.raises(TypeError, match="clean, noisy, mask"):
        a.train_step_multi(clean, noisy, l1_w_s=L1S)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("amount", [s for s in range(-5, 6) if s])
def test_device_shift_roll_equals_torch_and_jax(amount, dtype):
    gen = torch.Generator().manual_seed(amount + 10)
    x = torch.randn(2, 3, 37, generator=gen).to(dtype)
    shift, right = torch.tensor(abs(amount)), torch.tensor(int(amount > 0))
    got = phase_shift_roll(x, shift, right)
    assert torch.equal(got, torch.roll(x, amount, dims=2))
    assert torch.equal(phase_shift_roll(x, abs(amount), amount > 0), got)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32)
    want = jax_roll(jnp.transpose(jx, (0, 2, 1)), jnp.int32(abs(amount)),
                    jnp.bool_(amount > 0), 5)
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.transpose(np.asarray(want.astype(jnp.float32)), (0, 2, 1)))
    # the gradient is the inverse roll
    xg = x.clone().requires_grad_()
    g = torch.randn(2, 3, 37, generator=gen).to(dtype)
    phase_shift_roll(xg, shift, right).backward(g)
    assert torch.equal(xg.grad, torch.roll(g, -amount, dims=2))


def test_d_rolls_by_draws_on_its_device_as_by_host_ints():
    seg = _engine("segan")
    seg.init_train()
    x = torch.randn(B, 2, T, generator=torch.Generator().manual_seed(1))
    phase = seg.D.sample_phase(torch.Generator().manual_seed(2))
    seg.D.train()
    on_device, _ = seg.D(x, phase=phase)
    by_ints, _ = seg.D(x, phase=phase.numpy())
    assert torch.equal(on_device, by_ints)


@pytest.mark.parametrize("opt", ["rmsprop", "adam"])
def test_capturable_state_loads_into_an_eager_engine(opt, tmp_path):
    """Two eager steps, the optimizers switched to capturable (step counts kept as
    tensors; here on the CPU) and saved: the payload loads into an eager engine, equals
    the one written without the switch, and that engine steps on."""
    kind = "segan" if opt == "rmsprop" else "aewsegan"
    seg = _engine(kind, opt=opt)
    clean, noisy, mask = _stack(50)
    for i in range(S):
        seg.train_step(clean[i], noisy[i], mask[i], L1S[i])
    saved = {}
    for name, on in (("eager", False), ("capturable", True)):
        for o in seg._optimizers():
            set_capturable(o, on)
            assert all(g["capturable"] == on for g in o.param_groups)
        Saver(str(tmp_path / name), prefix="EOE_G-").save("Generator", S, seg.G, seg.g_opt,
                                                          trained_steps=S)
        saved[name] = torch.load(tmp_path / name / f"weights_EOE_G-Generator-{S}.ckpt",
                                 weights_only=True)["optimizer"]
    a, b = saved["eager"], saved["capturable"]
    assert a["param_groups"] == b["param_groups"]
    assert all(not g["capturable"] for g in b["param_groups"])
    for i in a["state"]:
        for k, v in a["state"][i].items():
            assert torch.equal(v, b["state"][i][k]) and v.device.type == "cpu", (i, k)
    fresh = _engine(kind, opt=opt)
    fresh.init_train()
    fresh.g_opt.load_state_dict(b)
    assert all(not g["capturable"] for g in fresh.g_opt.param_groups)
    fresh.G.load_state_dict(seg.G.state_dict())
    fresh.train_step(clean[0], noisy[0], mask[0], 100.0)
    assert all(torch.isfinite(p).all() for p in fresh.G.parameters())


def test_multi_step_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """No silent CPU: without a card the engine (and the CLI with --steps_per_call)
    refuses unless asked for the CPU; a device neither cuda nor cpu is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SEGAN(SEGANConfig(**TOY))
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--save_path", str(tmp_path / "ck"), "--steps_per_call", "4"])
    seg = _engine("segan")
    seg.init_train()
    seg.device = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        seg.train_step_multi(*(torch.zeros(v.shape, device="meta") for v in _stack(0)),
                             l1_w_s=L1S)


def test_prepare_on_the_cpu_leaves_the_optimizers_eager():
    seg = _engine("segan")
    assert seg.prepare_multi_step(4) is seg
    assert seg._multi is None
    assert all(not g.get("capturable") for o in seg._optimizers() for g in o.param_groups)
    seg.release_multi_step()


def test_stack_group_stacks_loader_batches():
    rng = np.random.RandomState(0)
    batches = [{"clean": torch.from_numpy(rng.randn(B, T).astype(np.float32)),
                "noisy": torch.from_numpy(rng.randn(B, T).astype(np.float32)),
                "mask": torch.ones(B), "additive_mask": np.float32([0, 1, 0, 0])}
               for _ in range(3)]
    batches[1]["mask"] = None
    clean, noisy, mask, amask = SEGAN._stack_group(batches, ("additive_mask",))
    assert clean.shape == noisy.shape == (3, B, T, 1) and mask.shape == amask.shape == (3, B)
    assert torch.equal(clean[2, :, :, 0], batches[2]["clean"]) and float(mask.sum()) == 3 * B
    assert json.dumps(amask.tolist()) == json.dumps([[0.0, 1.0, 0.0, 0.0]] * 3)
