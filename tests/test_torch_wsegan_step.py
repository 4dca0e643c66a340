"""The port's WSEGAN train step (``WSEGAN.train_step``) against the JAX package's
``make_wsegan_train_step`` at toy width (slice 1024, fmaps 8/16/32 in G and D, z_dim 32,
pool_slen 16), spectral norm in G and D, Adam, from identical weights, u and v.

Both sides get the same batches, the same z (the one the JAX step returns), the same
phase draws (recorded from the JAX step's D, real, fake, [misaligned], [interfered] and
G's pass, by ``test_torch_discriminator.record_phase``), and the misalignment permutation
and square waves that the JAX step draws from its split keys, recomputed here.
"""
import numpy as np
import pytest

import jax
import torch

from segan_pytorch_tpu.models.wsegan import WSEGAN as JaxWSEGAN, _square_wave_batch
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.wsegan import (INTERF_AMPS, INTERF_FREQS, WSEGAN,
                                                   square_wave_batch, square_waves)
from segan_pytorch_tpu_torch.utils.checkpoint import (discriminator_state_from_jax,
                                                      generator_state_from_jax)
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_discriminator import record_phase
from test_torch_wsegan_models import snorm_randomize

# scripts/run_wsegan_train.sh's flags at toy width (G and D with biases)
TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
           z_dim=32, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16,
           wsegan=True, gnorm_type="snorm", dnorm_type="snorm", opt="adam",
           misalign_pair=True)
B, T, L1 = 4, 1024, 100.0
STEP_TOL = 1e-5   # one step: the losses, relative
STATE_TOL = 1e-4  # one step: every parameter, u and v (L2, relative)
TRAJ_TOL = 1e-3   # ten steps: the losses at every step
# (config changes, mask, additive mask) of each case
CASES = {
    "misalign": ({}, [1, 1, 1, 1], [0, 0, 0, 0]),
    "interf": (dict(misalign_pair=False, interf_pair=True), [1, 1, 1, 1], [0, 0, 0, 0]),
    "interf_and_misalign": (dict(interf_pair=True), [1, 1, 1, 1], [0, 0, 0, 0]),
}
# the cost of vanilla_gan, the L1 term's rows and a masked row (test_torch_wsegan_traj.py)
MORE_CASES = {
    "vanilla_gan": (dict(vanilla_gan=True), [1, 1, 1, 1], [0, 0, 0, 0]),
    "additive": ({}, [1, 1, 1, 1], [0, 1, 0, 1]),
    "masked_row": ({}, [1, 1, 1, 0], [0, 0, 1, 1]),
}


def batch(i):
    """Step i's batch, as bench.py builds one."""
    rng = np.random.RandomState(200 + i)
    clean = (rng.randn(B, T, 1) * 0.1).astype(np.float32)
    noisy = clean + (rng.randn(B, T, 1) * 0.02).astype(np.float32)
    return clean, noisy


def n_passes(cfg):
    return 3 + int(cfg.get("misalign_pair", False)) + int(cfg.get("interf_pair", False))


def jax_draws(key):
    """The misalignment permutation and the square waves of the JAX step with `key`."""
    keys = jax.random.split(key, 9)
    return (np.asarray(jax.random.permutation(keys[6], B)),
            np.asarray(_square_wave_batch(keys[7], B, T)))


def jax_run(kw, steps, masks, amasks, tmp):
    """`steps` JAX steps from randomised weights, u and v: per step the losses, Genh, z,
    phase draws, perm and squares; the variables before and after, in the port's names."""
    cfg = dict(TOY, **kw)
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        jseg = JaxWSEGAN(JaxConfig(**cfg, save_path=str(tmp)))
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
        out = []
        for i in range(steps):
            draws.clear()
            key = jax.random.PRNGKey(30 + i)
            metrics, genh, z = jseg.train_step(*batch(i), np.asarray(masks[i], np.float32),
                                               np.asarray(amasks[i], np.float32), key, L1)
            jax.effects_barrier()
            perm, squares = jax_draws(key)
            out.append(dict({k: float(v) for k, v in metrics.items()},
                            genh=np.array(genh, np.float32), z=np.array(z, np.float32),
                            perm=perm, squares=squares,
                            phase=np.array(draws).reshape(n_passes(cfg), 3, 2)))
        st = jseg.state
        g_end = flatten_tree({"params": st.g_params, **st.g_vars})
        d_end = flatten_tree({"params": st.d_params, **st.d_vars})
    return port_state(g_flat, d_flat), port_state(g_end, d_end), out


def port_state(g_flat, d_flat):
    return (generator_state_from_jax(g_flat),
            discriminator_state_from_jax(d_flat, TOY["dpool_slen"], TOY["denc_fmaps"][-1]))


def port_engine(g_sd, d_sd, **kw):
    cfg = SEGANConfig(**dict(TOY, **kw))
    G, D = build_generator(cfg), build_discriminator(cfg)
    G.load_state_dict(g_sd, strict=True)
    D.load_state_dict(d_sd, strict=True)
    return WSEGAN(cfg, generator=G, discriminator=D, device="cpu")


def port_step(seg, i, ref, mask, amask):
    metrics, genh, _ = seg.train_step(*batch(i), np.asarray(mask, np.float32),
                                      np.asarray(amask, np.float32), L1, z=ref["z"],
                                      phase=ref["phase"], perm=ref["perm"],
                                      squares=ref["squares"])
    return {k: float(v) for k, v in metrics.items()}, genh


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def _state_errs(seg, end):
    errs = {}
    for side, want in zip(("G", "D"), end):
        sd = getattr(seg, side).state_dict()
        assert set(sd) == set(want), (side, set(sd) ^ set(want))
        for k, v in sd.items():
            errs[f"{side}.{k}"] = float((v.double() - want[k].double()).norm()
                                        / want[k].double().norm())
    return errs


def check_one_step(kw, mask, amask, tmp_path):
    """One step from the same start on both sides: the losses (d_loss, g_loss, g_adv,
    pow_loss, den_loss and each pair's) and Genh within 1e-5; afterwards every parameter
    of G and D and every u and v within 1e-4."""
    start, end, ref = jax_run(kw, 1, [mask], [amask], tmp_path)
    seg = port_engine(*start, **kw)
    got, genh = port_step(seg, 0, ref[0], mask, amask)
    want_keys = {"d_loss", "g_loss", "g_adv", "pow_loss", "den_loss", "d_real", "d_fake"}
    want_keys |= {"d_fake_shuf"} if kw.get("misalign_pair", True) else set()
    want_keys |= {"d_fake_inter"} if kw.get("interf_pair") else set()
    assert set(got) == set(ref[0]) - {"genh", "z", "perm", "squares", "phase"} == want_keys
    for k in want_keys:
        assert _rel(got[k], ref[0][k]) <= STEP_TOL, (k, got[k], ref[0][k])
    assert (got["den_loss"] > 0) == any(a and m for a, m in zip(amask, mask))
    np.testing.assert_allclose(genh.numpy(), ref[0]["genh"], rtol=STEP_TOL, atol=STEP_TOL)
    errs = _state_errs(seg, end)
    bad = {k: e for k, e in errs.items() if not e <= STATE_TOL}
    assert not bad, bad
    # the step moved every parameter and advanced every u and v, but those of one
    # element, which stay 1: G's output deconv's u, the snorm PReLU's v
    for side, s0 in zip(("G", "D"), start):
        sd = getattr(seg, side).state_dict()
        still = [k for k, v in s0.items() if torch.equal(sd[k], v)]
        assert still == [k for k, v in s0.items()
                         if v.numel() == 1 and k.endswith(("weight_u", "weight_v"))], still


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_matches_jax(case, tmp_path):
    check_one_step(*CASES[case], tmp_path)


def test_step_draws_come_from_the_engine_streams():
    """z, phase, perm and squares left to the engine come from its seeded streams: two
    engines with one seed take the same step, with all four pairs."""
    cfg = SEGANConfig(**dict(TOY, interf_pair=True, seed=3))
    clean, noisy = batch(1)
    runs = [WSEGAN(cfg, device="cpu").train_step(clean, noisy, None, None, L1)
            for _ in range(2)]
    (m1, g1, z1), (m2, g2, z2) = runs
    assert torch.equal(z1, z2) and torch.equal(g1, g2)
    assert all(float(m1[k]) == float(m2[k]) for k in m1) and len(m1) == 9


def test_square_waves_are_the_jax_ones():
    """The JAX step's square waves from their frequencies and amplitudes, drawn as the
    JAX ``_square_wave_batch`` draws them; the port's own draws take every frequency and
    amplitude."""
    key = jax.random.PRNGKey(7)
    kf, ka = jax.random.split(key)
    f = np.asarray(INTERF_FREQS, np.float32)[np.asarray(jax.random.randint(kf, (16,), 0, 3))]
    a = np.asarray(INTERF_AMPS, np.float32)[np.asarray(jax.random.randint(ka, (16,), 0, 4))]
    want = np.asarray(_square_wave_batch(key, 16, T))
    got = square_waves(torch.from_numpy(f), torch.from_numpy(a), T).numpy()
    np.testing.assert_array_equal(got, want)
    drawn = square_wave_batch(256, T, torch.Generator().manual_seed(0))[..., 0]
    assert set(drawn.abs().amax(dim=1).tolist()) == set(np.float32(INTERF_AMPS).tolist())
    flips = (drawn[:, 1:] != drawn[:, :-1]).sum(dim=1)  # 2 f flips a second, over 64 ms
    assert set(flips.tolist()) == {31, 127, 511}
