"""The port's Discriminator, its blocks, the losses and the optimizers against the JAX
package's, with the same random weights carried over by discriminator_state_from_jax,
the same numpy inputs and the same phase-shift draws.

Weights are drawn at scale 1/sqrt(fan_in), PReLU slopes in U(0, 0.3) and BatchNorm's
scales, shifts and running statistics away from their initial values, so every branch
and every leaf shows in the outputs. The JAX D's phase draws are recorded by a wrapper
around ``segan_pytorch_tpu.models.discriminator.phase_shift_roll`` (an ordered
``jax.debug.callback``) and fed to the port's D as its ``phase`` argument.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models import discriminator as jdisc
from segan_pytorch_tpu.models import modules as jmod
from segan_pytorch_tpu.models.segan import build_optimizer as jax_build_optimizer
from segan_pytorch_tpu.models.segan import (masked_bce_logits as jax_bce,
                                            masked_mse as jax_mse, reg_loss_fn as jax_reg)
from segan_pytorch_tpu.ops.roll import phase_shift_roll as jax_roll
from segan_pytorch_tpu.utils.checkpoint import (export_torch_discriminator, flatten_tree,
                                                load_torch_discriminator, save_pytree,
                                                unflatten_tree)
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models import modules as tmod
from segan_pytorch_tpu_torch.models.discriminator import Discriminator, build_discriminator
from segan_pytorch_tpu_torch.models.segan import (build_optimizer, masked_bce_logits,
                                                  masked_mse, reg_loss_fn)
from segan_pytorch_tpu_torch.ops.roll import phase_shift_roll
from segan_pytorch_tpu_torch.utils.checkpoint import (discriminator_state_from_jax,
                                                      load_discriminator,
                                                      save_discriminator)
from segan_pytorch_tpu_torch.utils.config import SEGANConfig

TOL = 1e-5       # fp32, toy width: XLA at HIGHEST vs torch's CPU ops, other sum orders
FULL_TOL = 1e-4  # fp32, full width: five 31-tap layers of up to 512 x 31 terms each
KEY = jax.random.PRNGKey(0)
TOY = dict(slice_size=1024, gkwidth=31, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4],
           dpool_slen=16)
HEADS = ["none", "conv", "gmax", "gavg", "mlp"]


def randomize(variables, seed):
    """{'params', 'batch_stats'} of a JAX D (or block) -> flat numpy leaves at O(1)
    scale: convs 1/sqrt(K Cin), Linears 1/sqrt(in), PReLU slopes U(0, 0.3), BN scales
    U(0.5, 1.5), running variances U(0.5, 1.5), biases and means N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_tree(variables).items():
        if path.endswith("running_var") or path.endswith("norm/weight"):
            out[path] = rng.uniform(0.5, 1.5, v.shape)
        elif v.ndim == 3:
            out[path] = rng.randn(*v.shape) / np.sqrt(v.shape[0] * v.shape[1])
        elif v.ndim == 2:
            out[path] = rng.randn(*v.shape) / np.sqrt(v.shape[0])
        elif path.endswith("weight"):  # the PReLU slopes
            out[path] = rng.uniform(0, 0.3, v.shape)
        else:
            out[path] = rng.randn(*v.shape) * 0.1
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def record_phase(monkeypatch):
    """Wrap the JAX D's roll so that each (shift, right) draw is appended, in program
    order, to the returned list, eagerly and under jit alike."""
    draws = []
    orig = jdisc.phase_shift_roll

    def rec(h, shift, right, max_shift):
        jax.debug.callback(lambda s, r: draws.append((int(s), int(r))), shift, right,
                           ordered=True)
        return orig(h, shift, right, max_shift)

    monkeypatch.setattr(jdisc, "phase_shift_roll", rec)
    return draws


def jax_d(seed=1, **kw):
    cfg = JaxConfig(**TOY, **kw)
    D = jdisc.build_discriminator(cfg)
    x = jnp.zeros((1, cfg.slice_size, 2))
    variables = D.init({"params": KEY, "phase": KEY}, x, train=True)
    return cfg, D, randomize(dict(variables), seed)


def port_d(cfg_kw, flat):
    cfg = SEGANConfig(**cfg_kw)
    D = build_discriminator(cfg)
    D.load_state_dict(discriminator_state_from_jax(flat, cfg.dpool_slen,
                                                   cfg.denc_fmaps[-1]), strict=True)
    return D


def _pair(B, T, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(B, T, 2).astype(np.float32) * 0.5


def _t(x):  # (B, T, C) numpy -> (B, C, T)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _n(t):  # (B, C, T) -> (B, T, C) numpy
    return t.detach().numpy().transpose(0, 2, 1)


def _logit(y, pool):
    """The port's logit in the JAX D's layout: 'mlp' is (B, 1, T') there (B, T', 1)."""
    return _n(y) if pool == "mlp" else y.detach().numpy()


def _check_stats(D, stats, tol):
    for i, blk in enumerate(D.enc_blocks):
        want = stats[f"enc_blocks_{i}"]["norm"]
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(blk.norm, name).numpy(),
                                       np.asarray(want[name]), rtol=tol, atol=tol,
                                       err_msg=f"enc_blocks.{i}.norm.{name}")


@pytest.mark.parametrize("pool", HEADS)
def test_forward_matches_jax_train_and_eval(pool, monkeypatch):
    """Train mode with a masked row (batch statistics, running statistics updated, the
    same phase draws), then eval mode (running statistics) on another batch."""
    cfg, D, flat = jax_d(seed=2, dpool_type=pool)
    tree = unflatten_tree(flat)
    draws = record_phase(monkeypatch)
    x = _pair(3, 1024, seed=3)
    mask = np.array([1, 1, 0], np.float32)
    (y_j, act_j), new = D.apply(tree, jnp.asarray(x), train=True, mask=jnp.asarray(mask),
                                mutable=["batch_stats"], rngs={"phase": KEY})
    jax.effects_barrier()
    assert len(draws) == 3 and all(1 <= s <= 5 for s, _ in draws)
    td = port_d(dict(TOY, dpool_type=pool), flat).train()
    y, act = td(_t(x), mask=torch.from_numpy(mask), phase=np.array(draws))
    np.testing.assert_allclose(_logit(y, pool), np.asarray(y_j), rtol=TOL, atol=TOL)
    for i in range(3):
        np.testing.assert_allclose(_n(act[f"h_{i}"]), np.asarray(act_j[f"h_{i}"]),
                                   rtol=TOL, atol=TOL, err_msg=f"h_{i}")
    _check_stats(td, new["batch_stats"], TOL)
    assert int(td.enc_blocks[0].norm.num_batches_tracked) == 1

    draws.clear()
    x2 = _pair(2, 1024, seed=4)
    y_j, _ = D.apply({"params": tree["params"], **new}, jnp.asarray(x2), train=False,
                     rngs={"phase": jax.random.PRNGKey(5)})
    jax.effects_barrier()
    with torch.no_grad():
        y, _ = td.eval()(_t(x2), phase=np.array(draws))
    np.testing.assert_allclose(_logit(y, pool), np.asarray(y_j), rtol=TOL, atol=TOL)


def test_no_phase_stream_means_no_roll(monkeypatch):
    """Without draws or a generator the port's D rolls nothing, as the JAX D without its
    'phase' stream; with a generator it draws shifts in [1, phase_shift]."""
    cfg, D, flat = jax_d(seed=6)
    draws = record_phase(monkeypatch)
    x = _pair(2, 1024, seed=7)
    y_j, _ = D.apply(unflatten_tree(flat), jnp.asarray(x), train=False)
    jax.effects_barrier()
    assert draws == []
    td = port_d(TOY, flat).eval()
    with torch.no_grad():
        y, _ = td(_t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=TOL, atol=TOL)
    phase = td.sample_phase(torch.Generator().manual_seed(0), passes=50)
    assert phase.shape == (50, 3, 2)
    assert set(phase[..., 0].flatten().tolist()) == {1, 2, 3, 4, 5}
    assert set(phase[..., 1].flatten().tolist()) == {0, 1}
    with torch.no_grad():  # a generator in place of draws: one pass's draws from it
        y_gen, _ = td(_t(x), generator=torch.Generator().manual_seed(1))
        y_drawn, _ = td(_t(x), phase=td.sample_phase(torch.Generator().manual_seed(1)))
    torch.testing.assert_close(y_gen, y_drawn, rtol=0, atol=0)
    assert not torch.equal(y_gen, y)


def test_full_width_none_head_matches_jax(monkeypatch):
    """SEGAN+'s D at full width (fmaps 64..1024, slice 16384, pool_slen 16), B=1."""
    cfg = JaxConfig()
    D = jdisc.build_discriminator(cfg)
    variables = D.init({"params": KEY, "phase": KEY}, jnp.zeros((1, 16384, 2)), train=True)
    flat = randomize(dict(variables), seed=8)
    draws = record_phase(monkeypatch)
    x = _pair(1, 16384, seed=9)
    (y_j, act_j), _ = D.apply(unflatten_tree(flat), jnp.asarray(x), train=True,
                              mutable=["batch_stats"], rngs={"phase": KEY})
    jax.effects_barrier()
    td = port_d({}, flat).train()
    with torch.no_grad():
        y, act = td(_t(x), phase=np.array(draws))
    assert y.shape == (1, 1)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=FULL_TOL, atol=FULL_TOL)
    h4, h4_j = _n(act["h_4"]), np.asarray(act_j["h_4"])
    assert float(np.abs(h4 - h4_j).max() / np.abs(h4_j).max()) <= FULL_TOL


@pytest.mark.parametrize("bn_impl", ["onepass", "twopass"])
@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_matches_jax(bn_impl, masked, monkeypatch):
    """Train mode against both JAX variance forms (the port computes the two-pass one),
    the running statistics after two batches, then eval mode."""
    monkeypatch.setenv("SEGAN_TPU_BN", bn_impl)
    rng = np.random.RandomState(10)
    xs = [(rng.randn(4, 64, 5) * 2 + 0.5).astype(np.float32) for _ in range(3)]
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None
    jb = jmod.BatchNorm1d(5)
    v = jb.init(KEY, jnp.asarray(xs[0]), train=True)
    params = {"weight": jnp.asarray(rng.uniform(0.5, 1.5, 5), jnp.float32),
              "bias": jnp.asarray(rng.randn(5) * 0.1, jnp.float32)}
    stats = v["batch_stats"]
    tb = tmod.BatchNorm1d(5)
    with torch.no_grad():
        tb.weight.copy_(torch.from_numpy(np.array(params["weight"])))
        tb.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    tmask = torch.from_numpy(mask) if masked else None
    for x in xs[:2]:
        y_j, new = jb.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            train=True, mask=None if mask is None else jnp.asarray(mask),
                            mutable=["batch_stats"])
        stats = new["batch_stats"]
        y = tb.train()(_t(x), tmask)
        np.testing.assert_allclose(_n(y), np.asarray(y_j), rtol=TOL, atol=TOL)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(stats[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)
    y_j = jb.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[2]))
    with torch.no_grad():
        y = tb.eval()(_t(xs[2]))
    np.testing.assert_allclose(_n(y), np.asarray(y_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("stride", [4, 1])
def test_gconv1d_block_with_bnorm_matches_jax(stride):
    """conv -> BatchNorm (a masked row) -> PReLU, the pre-activation after the norm."""
    x = np.random.RandomState(24).randn(3, 256, 6).astype(np.float32)
    mask = np.array([1, 0, 1], np.float32)
    jb = jmod.GConv1DBlock(6, 10, 31, stride=stride, norm_type="bnorm")
    flat = randomize(dict(jb.init(KEY, jnp.asarray(x), train=True)), seed=25)
    (h_j, a_j), _ = jb.apply(unflatten_tree(flat), jnp.asarray(x), train=True,
                             ret_linear=True, mask=jnp.asarray(mask),
                             mutable=["batch_stats"])
    sd = discriminator_state_from_jax({f"{k.split('/')[0]}/enc_blocks_0/"
                                       f"{k.split('/', 1)[1]}": v for k, v in flat.items()},
                                      16, 10)
    tb = tmod.GConv1DBlock(6, 10, 31, stride=stride, norm_type="bnorm")
    tb.load_state_dict({k[len("enc_blocks.0."):]: v for k, v in sd.items()}, strict=True)
    h, a = tb.train()(_t(x), ret_linear=True, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_n(h), np.asarray(h_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_n(a), np.asarray(a_j), rtol=TOL, atol=TOL)


def test_batchnorm_mask_equals_the_smaller_batch():
    x = torch.randn(5, 3, 40, generator=torch.Generator().manual_seed(11))
    a, b = tmod.BatchNorm1d(3), tmod.BatchNorm1d(3)
    y_masked = a(x, torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0]))
    y_small = b(x[:3])
    torch.testing.assert_close(y_masked[:3], y_small, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a.running_var, b.running_var, rtol=1e-6, atol=1e-6)
    y_masked.sum().backward()  # masked rows take no gradient through the statistics


def test_batchnorm_bf16_keeps_fp32_stats():
    bn = tmod.BatchNorm1d(4)
    x = torch.randn(2, 4, 32, generator=torch.Generator().manual_seed(12))
    y = bn(x.bfloat16())
    assert y.dtype == torch.bfloat16 and bn.running_mean.dtype == torch.float32
    torch.testing.assert_close(y.float(), tmod.BatchNorm1d(4)(x), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shift,right", [(1, True), (3, False), (5, True), (5, False)])
def test_phase_roll_and_its_gradient_match_jax(shift, right):
    x = np.random.RandomState(13).randn(2, 50, 3).astype(np.float32)
    ct = np.random.RandomState(14).randn(2, 50, 3).astype(np.float32)
    f = lambda v: jnp.sum(jax_roll(v, jnp.int32(shift), jnp.bool_(right), 5) * ct)
    g_j = jax.grad(f)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = phase_shift_roll(xt, shift, right)
    (y * _t(ct)).sum().backward()
    np.testing.assert_array_equal(_n(y), np.asarray(jax_roll(jnp.asarray(x),
                                                             jnp.int32(shift),
                                                             jnp.bool_(right), 5)))
    np.testing.assert_array_equal(_n(xt.grad), np.asarray(g_j))


def test_linear_matches_jax_and_has_the_reference_init():
    x = np.random.RandomState(15).randn(3, 24).astype(np.float32)
    jl = jmod.Linear(24, 7)
    p = jl.init(KEY, jnp.asarray(x))["params"]
    tl = tmod.Linear(24, 7)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(p["weight"]).T))
        tl.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jl.apply({"params": p}, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    big = tmod.Linear(4096, 256, generator=torch.Generator().manual_seed(0))
    a = np.sqrt(6.0 / (4096 + 256))
    w, b = big.weight.detach(), big.bias.detach()
    assert float(w.abs().max()) <= a
    assert abs(float(w.std()) * np.sqrt(3) / a - 1) < 0.01
    assert float(b.abs().max()) <= 1 / np.sqrt(4096)


def test_prelu_takes_features_and_time_layouts():
    act = tmod.PReLU(3, init_val=0.5)
    x = torch.tensor([[-2.0, 1.0, -1.0]])
    torch.testing.assert_close(act(x), torch.tensor([[-1.0, 1.0, -0.5]]))
    assert act(torch.randn(2, 3, 5)).shape == (2, 3, 5)


def test_sinc_d_builds_and_unknown_options_raise():
    # the SincConv front end (held against JAX in test_torch_sinc_d.py): a default D
    # with it has four blocks, from 64 channels of filter outputs
    sinc = build_discriminator(SEGANConfig(sinc_conv=True, dpool_slen=64))
    assert isinstance(sinc.sinc_conv, tmod.SincConv) and sinc.sinc_conv.N_filt == 32
    assert [blk.conv.weight.shape[:2] for blk in sinc.enc_blocks] == [
        (128, 64), (256, 128), (512, 256), (1024, 512)]
    # spectral norm is ported (test_torch_wsegan_models.py holds it against JAX)
    assert build_discriminator(SEGANConfig(**TOY, dnorm_type="snorm")).enc_blocks[0].norm \
        is None
    with pytest.raises(TypeError):
        build_discriminator(SEGANConfig(**TOY, dpool_type="avg"))
    with pytest.raises(ValueError):
        Discriminator(2, [8], 31, [4], pool_slen=None)


def test_d_convs_keep_their_bias_under_no_bias():
    D = build_discriminator(SEGANConfig(**TOY, no_bias=True))
    assert all(blk.conv.bias is not None for blk in D.enc_blocks)
    assert all(blk.norm is not None for blk in D.enc_blocks)


def _check_forward_equal(td, D, tree, seed, pool="none"):
    x = _pair(2, 1024, seed=seed)
    y_j, _ = D.apply(tree, jnp.asarray(x), train=False)
    with torch.no_grad():
        y, _ = td.eval()(_t(x))
    np.testing.assert_allclose(_logit(y, pool), np.asarray(y_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pool", HEADS)
def test_jax_export_strict_loads_into_port(pool, tmp_path):
    cfg, D, flat = jax_d(seed=16, dpool_type=pool)
    tree = unflatten_tree(flat)
    ckpt = str(tmp_path / "d.ckpt")
    export_torch_discriminator(tree, ckpt, cfg.dpool_slen, cfg.denc_fmaps[-1])
    td = build_discriminator(SEGANConfig(**TOY, dpool_type=pool))
    load_discriminator(td, ckpt)
    _check_forward_equal(td, D, tree, seed=17, pool=pool)


@pytest.mark.parametrize("pool", HEADS)
def test_port_save_loads_into_jax(pool, tmp_path):
    """The port's seeded D (slopes and BN leaves moved off their initial values) saved
    as a reference-format .ckpt, read by the JAX load_torch_discriminator."""
    cfg = SEGANConfig(**TOY, dpool_type=pool)
    gen = torch.Generator().manual_seed(18)
    td = build_discriminator(cfg, gen)
    with torch.no_grad():
        for name, t in list(td.named_parameters()) + list(td.named_buffers()):
            if name.endswith(("act.weight", "running_mean")) or name in (
                    "fc.1.weight", "fc.3.weight", "mlp.1.weight"):  # slopes, means
                t.uniform_(0.0, 0.3, generator=gen)
            elif name.endswith(("norm.weight", "running_var")):
                t.uniform_(0.5, 1.5, generator=gen)
    ckpt = str(tmp_path / "d.ckpt")
    save_discriminator(td, ckpt, step=7)
    assert torch.load(ckpt, weights_only=True)["step"] == 7
    tree = load_torch_discriminator(ckpt, cfg.dpool_slen, cfg.denc_fmaps[-1])
    D = jdisc.build_discriminator(JaxConfig(**TOY, dpool_type=pool))
    _check_forward_equal(td, D, tree, seed=19, pool=pool)


def test_jax_trainer_npz_checkpoint_loads(tmp_path):
    """The JAX trainer's Saver payload: {'state_dict': {'params', 'batch_stats'},
    'optimizer': ...} as an npz; the optimizer state is not the model's."""
    cfg, D, flat = jax_d(seed=20)
    tree = unflatten_tree(flat)
    path = str(tmp_path / "weights_EOE_D-Discriminator-3.ckpt")
    save_pytree(path, {"state_dict": tree, "optimizer": {"0": {"nu": tree["params"]}}},
                meta={"step": 3})
    td = build_discriminator(SEGANConfig(**TOY))
    load_discriminator(td, path + ".npz")
    _check_forward_equal(td, D, tree, seed=21)
    sd = td.state_dict()
    sd.pop("fc.4.bias")
    torch.save({"state_dict": sd}, str(tmp_path / "short.ckpt"))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_discriminator(td, str(tmp_path / "short.ckpt"))


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_losses_match_jax(label):
    rng = np.random.RandomState(22)
    logits = rng.randn(5, 1).astype(np.float32) * 2
    wide = rng.randn(5, 7, 1).astype(np.float32)
    a, b = rng.randn(5, 64, 1).astype(np.float32), rng.randn(5, 64, 1).astype(np.float32)
    for mask in (np.ones(5, np.float32), np.array([1, 1, 0, 1, 0], np.float32)):
        tm = torch.from_numpy(mask)
        for fn_t, fn_j, v in ((masked_mse, jax_mse, logits), (masked_mse, jax_mse, wide),
                              (masked_bce_logits, jax_bce, logits)):
            np.testing.assert_allclose(float(fn_t(torch.from_numpy(v), label, tm)),
                                       float(fn_j(jnp.asarray(v), label, jnp.asarray(mask))),
                                       rtol=1e-6, atol=1e-7)
        for kind in ("l1_loss", "mse_loss"):
            got = reg_loss_fn(kind)(torch.from_numpy(a).bfloat16(), torch.from_numpy(b), tm)
            want = jax_reg(kind)(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b),
                                 jnp.asarray(mask))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        reg_loss_fn("huber")


@pytest.mark.parametrize("opt", ["rmsprop", "adam"])
def test_build_optimizer_matches_jax(opt):
    """Five steps of the port's build_optimizer against the JAX one on the same
    gradients (Adam at upstream's betas (0, 0.9), passed as floats)."""
    rng = np.random.RandomState(23)
    w0, target = rng.randn(6, 5).astype(np.float32), rng.randn(6, 5).astype(np.float32)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = build_optimizer(opt, 1e-3, [tw], betas=(0, 0.9))
    assert not topt.defaults.get("fused")
    tx = jax_build_optimizer(opt, 1e-3)
    jw = jnp.asarray(w0)
    state = tx.init(jw)
    for _ in range(5):
        topt.zero_grad()
        ((tw - torch.from_numpy(target)) ** 2).sum().backward()
        topt.step()
        updates, state = tx.update(2.0 * (jw - jnp.asarray(target)), state, jw)
        jw = jw + updates
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):
        build_optimizer("sgd", 1e-3, [tw])
