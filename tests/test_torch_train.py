"""The port's three-phase train step (SEGAN.train_step) against the JAX package's
make_segan_train_step, at the toy config of ``__graft_entry__.py`` (slice 1024, fmaps
8/16/32 in G and D, z_dim 32, pool_slen 16) with --no_bias, from identical weights.

Both sides get the same batches, the same z (the one the JAX step returns) and the same
phase draws (recorded from the JAX step's D by the wrapper of
``test_torch_discriminator.record_phase``). Also here: the ragged batch, the no-silent-CPU
rule, mixed precision, the bench entry point and the tensor-core route's weight cache
across optimizer steps.
"""
import copy
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator, d_input
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.multistep import set_capturable
from segan_pytorch_tpu_torch.models.segan import SEGAN, build_optimizer, masked_mse
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from segan_pytorch_tpu_torch.utils.checkpoint import (discriminator_state_from_jax,
                                                      generator_state_from_jax)
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_discriminator import randomize, record_phase

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
           z_dim=32, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16,
           no_bias=True)
B, STEPS, L1 = 4, 20, 100.0
STEP_TOL = 1e-5   # one step: the four losses, relative
TRAJ_TOL = 1e-3   # 20 steps: losses at every step, and each tensor's total update (L2)
# D's conv biases feed a BatchNorm, which takes the per-channel mean out: their true
# gradient is 0, and RMSprop turns the rounding noise left in it into steps of ~10 lr, so
# their updates differ from backend to backend by design, and so do the running means
# that take them in. Held apart below: their gradients are checked to be noise.
BIAS_BEFORE_BN = {f"enc_blocks.{i}.{leaf}" for i in range(3)
                  for leaf in ("conv.bias", "norm.running_mean")}


def batch(i):
    """Step i's batch, as bench.py builds one; every fourth step has its last row
    masked out."""
    rng = np.random.RandomState(100 + i)
    clean = (rng.randn(B, 1024, 1) * 0.1).astype(np.float32)
    noisy = clean + (rng.randn(B, 1024, 1) * 0.02).astype(np.float32)
    mask = np.ones(B, np.float32)
    if i % 4 == 3:
        mask[-1] = 0.0
    return clean, noisy, mask


def port_state(g_flat, d_flat):
    """The JAX variables in the port's names, G's and D's state_dicts."""
    return (generator_state_from_jax(g_flat),
            discriminator_state_from_jax(d_flat, TOY["dpool_slen"], TOY["denc_fmaps"][-1]))


def port_engine(g_sd, d_sd, **kw):
    cfg = SEGANConfig(**TOY, **kw)
    G, D = build_generator(cfg), build_discriminator(cfg)
    G.load_state_dict(g_sd, strict=True)
    D.load_state_dict(d_sd, strict=True)
    return SEGAN(cfg, generator=G, discriminator=D, device="cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """20 JAX steps from randomised weights: per step the losses, Genh, z and the phase
    draws; the variables before and after."""
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        jseg = JaxSEGAN(JaxConfig(**TOY, save_path=str(tmp_path_factory.mktemp("j"))))
        jseg.init_state(jax.random.PRNGKey(0), batch_size=B)
        st = jseg.state
        g_flat = randomize({"params": st.g_params}, seed=1)
        d_flat = randomize({"params": st.d_params, **st.d_vars}, seed=2)
        g_tree, d_tree = unflatten_tree(g_flat), unflatten_tree(d_flat)
        jseg.state = st.replace(g_params=jax.device_put(g_tree["params"]),
                                d_params=jax.device_put(d_tree["params"]),
                                d_vars=jax.device_put({"batch_stats": d_tree["batch_stats"]}))
        jseg.prepare_train(B)
        steps = []
        for i in range(STEPS):
            draws.clear()
            metrics, genh, z = jseg.train_step(*batch(i), jax.random.PRNGKey(10 + i), L1)
            jax.effects_barrier()
            steps.append(dict({k: float(v) for k, v in metrics.items()},
                              genh=np.array(genh), z=np.array(z),
                              phase=np.array(draws).reshape(3, 3, 2)))
        st = jseg.state
        g_end = flatten_tree({"params": st.g_params})
        d_end = flatten_tree({"params": st.d_params, **st.d_vars})
    return port_state(g_flat, d_flat), port_state(g_end, d_end), steps


@pytest.fixture(scope="module")
def port_run(jax_run):
    (g0, d0), _, steps = jax_run
    seg = port_engine(g0, d0)
    out = []
    for i, ref in enumerate(steps):
        metrics, genh, z = seg.train_step(*batch(i), L1, z=ref["z"], phase=ref["phase"])
        out.append(dict({k: float(v) for k, v in metrics.items()}, genh=genh.numpy()))
    return seg, out


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def test_one_step_losses_and_genh_match_jax(jax_run, port_run):
    _, _, steps = jax_run
    _, out = port_run
    for k in ("d_real", "d_fake", "g_adv", "g_l1"):
        assert _rel(out[0][k], steps[0][k]) <= STEP_TOL, (k, out[0][k], steps[0][k])
    np.testing.assert_allclose(out[0]["genh"], steps[0]["genh"], rtol=STEP_TOL,
                               atol=STEP_TOL)


def test_twenty_step_trajectory_matches_jax(jax_run, port_run):
    """Losses within 1e-3 at every step, and each tensor's total update p20 - p0 within
    1e-3 of the JAX one in L2 (RMSprop's first steps move a weight by ~10 lr sign(g), so
    norms, not elements); D's running statistics too."""
    (g0, d0), (g20, d20), steps = jax_run
    seg, out = port_run
    for i, (got, want) in enumerate(zip(out, steps)):
        for k in ("d_real", "d_fake", "g_adv", "g_l1"):
            assert _rel(got[k], want[k]) <= TRAJ_TOL, (i, k, got[k], want[k])
    errs = {}
    for model, start, end in ((seg.G, g0, g20), (seg.D, d0, d20)):
        sd = model.state_dict()
        assert set(sd) == set(end)
        for name, v in sd.items():
            if name.endswith("num_batches_tracked") or name in BIAS_BEFORE_BN:
                continue
            want = (end[name] - start[name]).double()
            got = (v - start[name]).double()
            if name.endswith(("running_mean", "running_var")):
                want, got = end[name].double(), v.double()
            assert float(want.norm()) > 0, name
            errs[f"{type(model).__name__}.{name}"] = float((got - want).norm() / want.norm())
    bad = {k: e for k, e in errs.items() if not e <= TRAJ_TOL}
    assert not bad, bad


def test_gradients_land_on_every_parameter_and_d_keeps_its_own(jax_run):
    """After a step each parameter's .grad is that step's gradient: D's is the gradient
    of the summed real and fake losses at D's parameters before its update (G's
    objective through the updated D leaves it alone)."""
    (g0, d0), _, steps = jax_run
    seg = port_engine(g0, d0)
    D_before = copy.deepcopy(seg.D)
    clean, noisy, mask = (torch.from_numpy(v) for v in batch(0))
    _, genh, _ = seg.train_step(clean, noisy, mask, L1, z=steps[0]["z"],
                                phase=steps[0]["phase"])
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in list(seg.G.parameters()) + list(seg.D.parameters()))
    D_before.train()
    real, _ = D_before(d_input(clean, noisy), mask=mask, phase=steps[0]["phase"][0])
    fake, _ = D_before(d_input(genh, noisy), mask=mask, phase=steps[0]["phase"][1])
    (masked_mse(real, 1.0, mask) + masked_mse(fake, 0.0, mask)).backward()
    for (name, p), q in zip(seg.D.named_parameters(), D_before.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-8, msg=name)
    for i, blk in enumerate(seg.D.enc_blocks):  # the biases that feed a BatchNorm
        ratio = float(blk.conv.bias.grad.norm() / blk.norm.bias.grad.norm())
        assert ratio <= 1e-5, (i, ratio)


def test_ragged_batch_equals_the_smaller_batch(jax_run):
    """Trailing rows with mask 0 change nothing: BN statistics, losses, gradients and
    the updated weights equal those of the batch without them."""
    (g0, d0), _, steps = jax_run
    clean, noisy, _ = batch(1)
    mask = np.array([1, 1, 1, 0], np.float32)
    z, phase = steps[1]["z"], steps[1]["phase"]
    big, small = port_engine(g0, d0), port_engine(g0, d0)
    m_big, genh_big, _ = big.train_step(clean, noisy, mask, L1, z=z, phase=phase)
    m_small, genh_small, _ = small.train_step(clean[:3], noisy[:3], None, L1, z=z[:3],
                                              phase=phase)
    for k in m_big:
        assert _rel(float(m_big[k]), float(m_small[k])) <= 1e-5, k
    torch.testing.assert_close(genh_big[:3], genh_small, rtol=1e-5, atol=1e-6)
    for model in ("G", "D"):
        for (name, p), q in zip(getattr(big, model).named_parameters(),
                                getattr(small, model).parameters()):
            if model == "D" and name in BIAS_BEFORE_BN:
                continue
            torch.testing.assert_close(p.grad, q.grad, rtol=1e-4, atol=1e-7, msg=name)
            torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)
    for name, v in small.D.state_dict().items():
        if name not in BIAS_BEFORE_BN:
            torch.testing.assert_close(big.D.state_dict()[name], v, rtol=1e-5, atol=1e-6,
                                       msg=name)


def test_engine_streams_are_seeded():
    """z=None and phase=None draw from the engine's seeded streams: two engines with one
    seed take the same step."""
    cfg = SEGANConfig(**TOY, seed=3)
    clean, noisy, mask = batch(2)
    runs = [SEGAN(cfg, device="cpu").train_step(clean, noisy, mask, L1) for _ in range(2)]
    (m1, g1, z1), (m2, g2, z2) = runs
    assert torch.equal(z1, z2) and torch.equal(g1, g2)
    assert all(float(m1[k]) == float(m2[k]) for k in m1)
    assert z1.shape == (B, 16, 32)


def test_training_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SEGAN(SEGANConfig(**TOY))
    m, genh, _ = SEGAN(SEGANConfig(**TOY), device="cpu").train_step(*batch(0), L1)
    assert genh.device.type == "cpu" and np.isfinite(float(m["g_l1"]))


def test_bf16_step_keeps_fp32_masters_and_refreshes_the_inference_copy(jax_run):
    """Under bf16 the gradients land on the fp32 parameters, the losses stay close to
    the fp32 step's, and G's bf16 inference copy follows the updated weights."""
    (g0, d0), _, steps = jax_run
    z, phase = steps[0]["z"], steps[0]["phase"]
    f32, bf = port_engine(g0, d0), port_engine(g0, d0, compute_dtype="bfloat16")
    x = torch.from_numpy(batch(5)[1])
    bf.infer_G(x, z)  # builds the bf16 copy before the step
    m32, _, _ = f32.train_step(*batch(0), L1, z=z, phase=phase)
    m16, _, _ = bf.train_step(*batch(0), L1, z=z, phase=phase)
    for p in list(bf.G.parameters()) + list(bf.D.parameters()):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    for k in m32:
        assert _rel(float(m16[k]), float(m32[k])) <= 5e-2, (k, float(m16[k]), float(m32[k]))
    fresh = copy.deepcopy(bf.G).to(torch.bfloat16)
    with torch.no_grad():
        want = fresh(x.bfloat16(), torch.from_numpy(z).bfloat16()).float()
    torch.testing.assert_close(bf.infer_G(x, z), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("foreach", [False, True])
@pytest.mark.parametrize("opt", ["rmsprop", "adam", "rmsprop+capturable", "adam+capturable"])
def test_weight_cache_is_fresh_after_an_optimizer_step(opt, foreach, dtype, monkeypatch):
    """The tensor-core route pads (and in fp32 splits) each weight once per version
    (``_padded_weights``); the port's optimizer steps update weights in place, so each
    must bump the version and the next call must see a fresh entry, never a stale one.
    Also the capturable steps that a CUDA graph of the train step records
    (``models/multistep.py`` ``set_capturable``), run here on the CPU."""
    opt, _, capturable = opt.partition("+")
    if capturable:  # torch allows them on accelerators only; the math is the same
        for mod in (importlib.import_module("torch.optim.rmsprop"),
                    importlib.import_module("torch.optim.adam")):
            monkeypatch.setattr(mod, "_get_capturable_supported_devices",
                                lambda supports_xla=True: ["cuda", "cpu"])
    g = torch.Generator().manual_seed(0)
    w = torch.nn.Parameter((torch.randn(16, 8, 31, generator=g) * 0.1).to(dtype))
    o = build_optimizer(opt, 1e-2, [w])
    for group in o.param_groups:
        group["foreach"] = foreach
    set_capturable(o, bool(capturable))
    as_list = lambda v: list(v) if isinstance(v, tuple) else [v]
    for _ in range(2):
        before = [t.clone() for t in as_list(K._padded_weights(w))]
        version = w._version
        w.grad = torch.randn(w.shape, generator=g).to(dtype)
        o.step()
        assert w._version > version
        got, want = as_list(K._padded_weights(w)), as_list(K._mma_weights(w))
        for a, b, old in zip(got, want, before):
            assert torch.equal(a, b)
            assert not torch.equal(a, old)


def test_bench_cli_prints_its_json_line():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "segan_pytorch_tpu_torch.bench", "--device", "cpu",
         "--preset", "tiny", "--steps", "1", "--warmup", "1", "--batch_size", "4"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["metric"] == "train_slices_per_sec_per_chip" and res["value"] > 0
    assert (res["unit"], res["batch"], res["compute_dtype"], res["device"]) == (
        "slices/s/chip", 4, "bfloat16", "cpu")
