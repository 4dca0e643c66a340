"""``--resume`` from a run directory that the JAX trainer wrote: its npz EOE checkpoints,
parameters and optax state, at toy width (the configs of ``tests/test_torch_train.py``
and ``tests/test_torch_wsegan_step.py``), on the CPU.

A JAX engine from randomised weights takes two steps and saves its EOE G and D as its
loop does (named after the iteration, 3, which is also the meta step); SEGAN+ with
RMSprop, WSEGAN with spectral norm and Adam. A fresh port engine resumes the directory:
its parameters, spectral-norm and BatchNorm state and optimizer moments must equal the
JAX ones in the port's layout, its step the meta step. The JAX engine then resumes the
same directory (after a throwaway step that the resume must undo) and both take the
next step on the same batch and draws: the losses within ``STEP_TOL`` and every
parameter after within ``STATE_TOL``, the tolerances of the step tests. SEGAN+ leaves
out D's conv biases and the running means that take them in (``BIAS_BEFORE_BN``): their
true gradient is 0 and RMSprop turns the rounding noise into steps that differ between
backends by design, as ``tests/test_torch_train.py`` holds them apart. Last, the CLI
resumes a JAX directory and trains on."""
import numpy as np
import pytest
import torch

import jax

from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.models.wsegan import WSEGAN as JaxWSEGAN
from segan_pytorch_tpu.utils.checkpoint import Saver as JaxSaver, flatten_tree, unflatten_tree
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch import train as ttrain
from segan_pytorch_tpu_torch.models.multistep import set_capturable
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
from segan_pytorch_tpu_torch.utils.checkpoint import (Saver, discriminator_state_from_jax,
                                                      generator_state_from_jax,
                                                      optimizer_state_from_jax)
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import write_pairs
from test_torch_discriminator import randomize, record_phase
from test_torch_train import BIAS_BEFORE_BN, STEP_TOL, TOY as SEGAN_TOY, batch as segan_batch
from test_torch_wsegan_models import snorm_randomize
from test_torch_wsegan_step import STATE_TOL, TOY as WS_TOY, batch as ws_batch, jax_draws

B, L1 = 4, 100.0
CASES = {
    "segan_rmsprop": dict(toy=SEGAN_TOY, jax=JaxSEGAN, port=SEGAN, slots=("square_avg",)),
    "wsegan_adam": dict(toy=WS_TOY, jax=JaxWSEGAN, port=WSEGAN,
                        slots=("exp_avg", "exp_avg_sq")),
}
OPTAX = {"square_avg": "nu", "exp_avg": "mu", "exp_avg_sq": "nu"}


def _jax_step(jseg, case, i, draws):
    """JAX step i on the case's batch i; returns its losses and the draws it made."""
    key = jax.random.PRNGKey(40 + i)
    draws.clear()
    if case == "segan_rmsprop":
        clean, noisy, mask = segan_batch(i)
        metrics, _, z = jseg.train_step(clean, noisy, mask, key, L1)
        extra = {}
    else:
        clean, noisy = ws_batch(i)
        amask = np.array([0, 1, 0, 1], np.float32)
        metrics, _, z = jseg.train_step(clean, noisy, np.ones(B, np.float32), amask, key,
                                        L1)
        perm, squares = jax_draws(key)
        extra = dict(perm=perm, squares=squares)
    jax.effects_barrier()
    n_passes = len(draws) // 3
    return ({k: float(v) for k, v in metrics.items()},
            dict(extra, z=np.array(z, np.float32), phase=np.array(draws).reshape(
                n_passes, 3, 2)))


def _port_step(seg, case, i, draws):
    if case == "segan_rmsprop":
        clean, noisy, mask = segan_batch(i)
        metrics, _, _ = seg.train_step(clean, noisy, mask, L1, **draws)
    else:
        clean, noisy = ws_batch(i)
        metrics, _, _ = seg.train_step(clean, noisy, np.ones(B, np.float32),
                                       np.array([0, 1, 0, 1], np.float32), L1, **draws)
    return {k: float(v) for k, v in metrics.items()}


def _port_states(jseg, cfg):
    """The JAX engine's G and D variables and optax states in the port's names."""
    st = jseg.state
    g_flat = flatten_tree({"params": st.g_params, **st.g_vars})
    d_flat = flatten_tree({"params": st.d_params, **st.d_vars})
    bridges = (generator_state_from_jax,
               lambda f: discriminator_state_from_jax(f, cfg["dpool_slen"],
                                                      cfg["denc_fmaps"][-1]))
    from flax import serialization

    opts = [flatten_tree(serialization.to_state_dict(o)) for o in (st.g_opt, st.d_opt)]
    return [(bridge(flat), flat, opt) for bridge, flat, opt in zip(bridges, (g_flat, d_flat),
                                                                   opts)]


@pytest.fixture(scope="module", params=list(CASES))
def resumed(request, tmp_path_factory):
    case = request.param
    spec = CASES[case]
    save = tmp_path_factory.mktemp(case)
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        jseg = spec["jax"](JaxConfig(**spec["toy"], save_path=str(save)))
        jseg.init_state(jax.random.PRNGKey(0), batch_size=B)
        st = jseg.state
        rand = randomize if case == "segan_rmsprop" else snorm_randomize
        g = unflatten_tree(rand({"params": st.g_params, **st.g_vars}, seed=1))
        d = unflatten_tree(rand({"params": st.d_params, **st.d_vars}, seed=2))
        jseg.state = st.replace(
            g_params=jax.device_put(g.pop("params")), g_vars=jax.device_put(g),
            d_params=jax.device_put(d.pop("params")), d_vars=jax.device_put(d))
        jseg.prepare_train(B)
        for i in range(2):
            _jax_step(jseg, case, i, draws)
        jseg.save(JaxSaver(str(save), max_ckpts=3, prefix="EOE_G-"),
                  JaxSaver(str(save), max_ckpts=3, prefix="EOE_D-"), 3)
        saved = _port_states(jseg, spec["toy"])
        _jax_step(jseg, case, 5, draws)  # a step that the resume must undo
        assert jseg.resume(str(save)) == 3
        want, ref = _jax_step(jseg, case, 2, draws)
        after = _port_states(jseg, spec["toy"])

    seg = spec["port"](SEGANConfig(**spec["toy"], save_path=str(save)), device="cpu")
    step = seg.resume(str(save))
    return dict(case=case, spec=spec, seg=seg, step=step, saved=saved, want=want,
                ref=ref, after=after)


def test_resume_loads_the_jax_state_and_moments(resumed):
    seg, spec, saved = resumed["seg"], resumed["spec"], resumed["saved"]
    assert resumed["step"] == seg.step == 3
    for model, opt, (state, flat, opt_flat) in ((seg.G, seg.g_opt, saved[0]),
                                                (seg.D, seg.d_opt, saved[1])):
        sd = model.state_dict()
        assert set(sd) == set(state)
        for k, v in state.items():
            assert torch.equal(sd[k], v), k
        # each moment is the JAX slot of its parameter, in the parameter's layout
        slots = {s: {k[len(f"0/{OPTAX[s]}/"):]: v for k, v in opt_flat.items()
                     if k.startswith(f"0/{OPTAX[s]}/")} for s in spec["slots"]}
        # Adam's count (2 steps taken) is every step; RMSprop has none: the meta step
        want_step = 2.0 if "exp_avg" in spec["slots"] else 3.0
        assert ("0/count" in opt_flat) == ("exp_avg" in spec["slots"])
        params = dict(model.named_parameters())
        for name, p in params.items():
            st = opt.state[p]
            assert set(st) == {"step", *spec["slots"]}, name
            assert st["step"].dtype == torch.float32 and float(st["step"]) == want_step
            for s in spec["slots"]:
                assert st[s].shape == p.shape and float(st[s].abs().max()) > 0, (name, s)
        # independent of the bridges: enc 0's conv weight (K, Cin, Cout) -> (Cout, Cin, K)
        name = "enc_blocks.0.conv.weight" + ("_orig" if "snorm" in str(spec["toy"]) else "")
        for s in spec["slots"]:
            jw = slots[s]["enc_blocks_0/conv/weight"]
            np.testing.assert_array_equal(opt.state[params[name]][s].numpy(),
                                          np.transpose(jw, (2, 1, 0)))


def test_resumed_step_matches_the_resumed_jax_step(resumed):
    seg, case, want, ref = resumed["seg"], resumed["case"], resumed["want"], resumed["ref"]
    got = _port_step(seg, case, 2, ref)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= STEP_TOL * max(abs(want[k]), 1e-12), (
            k, got[k], want[k])
    errs = {}
    for model, (state, _, _) in ((seg.G, resumed["after"][0]), (seg.D, resumed["after"][1])):
        sd = model.state_dict()
        for k, v in state.items():
            if k.endswith("num_batches_tracked") or (case == "segan_rmsprop" and model is seg.D
                                                     and k in BIAS_BEFORE_BN):
                continue
            ref_v = v.double()
            errs[f"{type(model).__name__}.{k}"] = float(
                (sd[k].double() - ref_v).norm() / max(float(ref_v.norm()), 1e-30))
    bad = {k: e for k, e in errs.items() if not e <= STATE_TOL}
    assert not bad, bad


def test_optimizer_slots_must_match(resumed):
    """An Adam payload does not load into RMSprop, nor the reverse; capturable keeps the
    step counts as tensors."""
    seg, spec, saved = resumed["seg"], resumed["spec"], resumed["saved"]
    state, flat, opt_flat = saved[0]
    other = torch.optim.Adam if spec["slots"] == ("square_avg",) else torch.optim.RMSprop
    with pytest.raises(ValueError, match="slots"):
        optimizer_state_from_jax(opt_flat, other(seg.G.parameters()), seg.G, flat,
                                 generator_state_from_jax, 3)
    set_capturable(seg.g_opt, True)
    sd = optimizer_state_from_jax(opt_flat, seg.g_opt, seg.G, flat, generator_state_from_jax,
                                  3)
    seg.g_opt.load_state_dict(sd)
    assert all(st["step"].device == p.device for p, st in seg.g_opt.state.items())
    set_capturable(seg.g_opt, False)


def test_the_cli_resumes_a_jax_run_directory(tmp_path):
    """train.main --resume on a directory of the JAX trainer's EOE checkpoints (meta step
    3, one epoch of three batches): 'Resumed from step 3', then the second epoch."""
    toy = dict(slice_size=4096, genc_fmaps=[8, 16], genc_poolings=[4, 4], z_dim=16,
               denc_fmaps=[8, 16], denc_poolings=[4, 4], dpool_slen=256, no_bias=True)
    save = tmp_path / "ck"
    jseg = JaxSEGAN(JaxConfig(**toy, save_path=str(save)))
    jseg.init_state(jax.random.PRNGKey(0), batch_size=4)
    jseg.save(JaxSaver(str(save), max_ckpts=3, prefix="EOE_G-"),
              JaxSaver(str(save), max_ckpts=3, prefix="EOE_D-"), 3)
    assert Saver(str(save), prefix="EOE_G-").load_weights()[0]["format"] == "jax"
    corpus = write_pairs(tmp_path / "train", [12000, 10000, 9000])
    args = ["--batch_size", "4", "--slice_size", "4096", "--genc_fmaps", "8", "16",
            "--genc_poolings", "4", "4", "--z_dim", "16", "--denc_fmaps", "8", "16",
            "--denc_poolings", "4", "4", "--dpool_slen", "256", "--no_bias",
            "--no_train_gen", "--save_freq", "1"]
    seg = ttrain.main(["--save_path", str(save), "--clean_trainset", corpus[0],
                       "--noisy_trainset", corpus[1], "--cache_dir", str(tmp_path / "c"),
                       "--epoch", "2", "--resume", "--device", "cpu"] + args)
    assert seg.step == 6
    names = Saver(str(save), prefix="EOE_G-").read_latest_checkpoint()
    assert names == "EOE_G-Generator-7.ckpt"
