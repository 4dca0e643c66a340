"""The checkpoint bridge of spectral norm's 'spectral' collection both ways (JAX npz ->
the port, the port -> JAX's torch loaders, the v permutations) and ``ops/stft.py``
``power_spectrum_db`` against the JAX one; the snorm models and helpers of
``test_torch_wsegan_models.py``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.ops.stft import power_spectrum_db as jax_power_db
from segan_pytorch_tpu.utils.checkpoint import (load_torch_discriminator,
                                                load_torch_generator, save_pytree,
                                                unflatten_tree)
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.ops.stft import power_spectrum_db
from segan_pytorch_tpu_torch.utils.checkpoint import (discriminator_state_from_jax,
                                                      generator_state_from_jax,
                                                      load_discriminator, load_generator,
                                                      save_discriminator, save_generator)
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_wsegan_models import (CL, D_TOY, G_TOY, MODEL_TOL, _g_io, _jax_d, _jax_g,
                                      _port_d, _port_g, _rel)


def test_jax_npz_loads_strictly_into_the_port(tmp_path):
    """The JAX trainer's npz (params + spectral) -> the port's strict load -> equal eval
    forwards, G and D."""
    G, gflat = _jax_g(seed=7)
    save_pytree(str(tmp_path / "g.npz"), unflatten_tree(gflat))
    tg = build_generator(SEGANConfig(**G_TOY))
    load_generator(tg, str(tmp_path / "g.npz"))
    x, z = _g_io(seed=8)
    y_j = G.apply(unflatten_tree(gflat), jnp.asarray(x), z=jnp.asarray(z))
    with torch.no_grad():
        y = tg.eval()(torch.from_numpy(x), torch.from_numpy(z))
    assert _rel(y.numpy(), y_j) <= MODEL_TOL
    D, dflat = _jax_d("none", seed=9)
    save_pytree(str(tmp_path / "d.npz"), unflatten_tree(dflat))
    td = build_discriminator(SEGANConfig(**D_TOY))
    load_discriminator(td, str(tmp_path / "d.npz"))
    xd = np.random.RandomState(10).randn(2, 1024, 2).astype(np.float32)
    y_j, _ = D.apply(unflatten_tree(dflat), jnp.asarray(xd))
    with torch.no_grad():
        y, _ = td.eval()(torch.from_numpy(CL(xd)))
    assert _rel(y.numpy(), y_j) <= MODEL_TOL


@pytest.mark.parametrize("pool", ["none", "mlp"])
def test_port_checkpoints_load_in_jax(pool, tmp_path):
    """The port's save -> JAX load_torch_generator / load_torch_discriminator -> equal
    eval forwards (the JAX loader takes weight_orig, weight_u and weight_v into its
    params and spectral collections)."""
    G, gflat = _jax_g(seed=11)
    tg = _port_g(gflat)
    with torch.no_grad():  # u and v away from the JAX ones: the port's own state
        tg.train()(*(torch.from_numpy(a) for a in _g_io(seed=12)))
    save_generator(tg, str(tmp_path / "g.ckpt"))
    jtree = load_torch_generator(str(tmp_path / "g.ckpt"))
    x, z = _g_io(seed=13)
    y_j = G.apply(jtree, jnp.asarray(x), z=jnp.asarray(z))
    with torch.no_grad():
        y = tg.eval()(torch.from_numpy(x), torch.from_numpy(z))
    assert _rel(y.numpy(), y_j) <= MODEL_TOL
    D, dflat = _jax_d(pool, seed=14)
    td = _port_d(pool, dflat)
    save_discriminator(td, str(tmp_path / "d.ckpt"))
    jtree = load_torch_discriminator(str(tmp_path / "d.ckpt"), 16, 32)
    xd = np.random.RandomState(15).randn(2, 1024, 2).astype(np.float32)
    y_j, _ = D.apply(jtree, jnp.asarray(xd))
    with torch.no_grad():
        y, _ = td.eval()(torch.from_numpy(CL(xd)))
    got = CL(y.numpy()) if pool == "mlp" else y.numpy()
    assert _rel(got, y_j) <= MODEL_TOL


def test_v_permutations_matter():
    """A conv's v and fc.0's v reach the port reordered as their weights' columns are:
    left in the JAX order, the eval forward (sigma = u W v with the stored u, v)
    differs."""
    G, gflat = _jax_g(seed=16)
    x, z = _g_io(seed=17)
    y_j = np.asarray(G.apply(unflatten_tree(gflat), jnp.asarray(x), z=jnp.asarray(z)))
    sd = generator_state_from_jax(gflat)
    sd["enc_blocks.1.conv.weight_v"] = torch.from_numpy(
        gflat["spectral/enc_blocks_1/conv/weight_v"].reshape(-1))
    tg = build_generator(SEGANConfig(**G_TOY))
    tg.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y = tg.eval()(torch.from_numpy(x), torch.from_numpy(z))
    assert _rel(y.numpy(), y_j) > 100 * MODEL_TOL
    D, dflat = _jax_d("none", seed=18)
    xd = np.random.RandomState(19).randn(2, 1024, 2).astype(np.float32)
    y_j, _ = D.apply(unflatten_tree(dflat), jnp.asarray(xd))
    sd = discriminator_state_from_jax(dflat, 16, 32)
    sd["fc.0.weight_v"] = torch.from_numpy(dflat["spectral/fc_0/weight_v"].reshape(-1))
    td = build_discriminator(SEGANConfig(**D_TOY))
    td.load_state_dict(sd, strict=True)
    with torch.no_grad():
        y, _ = td.eval()(torch.from_numpy(CL(xd)))
    assert _rel(y.numpy(), y_j) > 100 * MODEL_TOL


def test_batch_stats_land_in_the_running_statistics():
    """A bnorm G's 'batch_stats' leaves become the norms' running statistics, beside
    num_batches_tracked 0 (held against JAX in test_torch_bnorm_g.py)."""
    mean = np.arange(4, dtype=np.float32)
    sd = generator_state_from_jax({
        "batch_stats/dec_blocks_0/norm/running_mean": mean,
        "batch_stats/dec_blocks_0/norm/running_var": mean + 1,
        "params/dec_blocks_0/norm/weight": np.ones(4, np.float32),
        "params/dec_blocks_0/norm/bias": np.zeros(4, np.float32)})
    assert set(sd) == {f"dec_blocks.0.norm.{k}" for k in (
        "running_mean", "running_var", "weight", "bias", "num_batches_tracked")}
    np.testing.assert_array_equal(sd["dec_blocks.0.norm.running_mean"].numpy(), mean)
    np.testing.assert_array_equal(sd["dec_blocks.0.norm.running_var"].numpy(), mean + 1)
    assert int(sd["dec_blocks.0.norm.num_batches_tracked"]) == 0


# -- the power spectrum ----------------------------------------------------------------
@pytest.mark.parametrize("T", [1024, 4096])
def test_power_spectrum_db_matches_jax(T):
    """n_fft = min(T, 2048), hop 160, a rectangular 320-sample window, normalized,
    reflect-centred: within 1e-4 dB of the JAX 'fft' method on every bin within 40 dB of
    its frame's peak (99.9 % of them). Below that an fp32 FFT's rounding shows in dB: the
    JAX one reads up to 1.2e-3 dB off a float64 STFT at -90 dB (T = 4096), so there the
    port is held to 2e-3 dB of float64. An all-zero row gives the floor, -190 dB, and a
    finite gradient."""
    rng = np.random.RandomState(20)
    x = (rng.randn(3, T) * 0.1).astype(np.float32)
    x[1] = 0.0
    want = np.asarray(jax_power_db(jnp.asarray(x), 2048, method="fft"))
    xt = torch.from_numpy(x).requires_grad_()
    got = power_spectrum_db(xt, 2048)
    assert got.shape == want.shape == (3, min(T, 2048) // 2 + 1, T // 160 + 1)
    err = np.abs(got.detach().numpy() - want)
    near = want >= want.max(axis=1, keepdims=True) - 40.0
    assert near.mean() > 0.99 and err[near].max() <= 1e-4
    exact = power_spectrum_db(torch.from_numpy(x).double(), 2048).numpy()
    assert np.abs(got.detach().numpy() - exact).max() <= 2e-3
    np.testing.assert_allclose(got[1].detach().numpy(), -190.0, atol=1e-4)
    got.sum().backward()
    assert torch.isfinite(xt.grad).all()
    g_j = jax.grad(lambda v: jnp.sum(jax_power_db(v, 2048, method="fft")))(jnp.asarray(x))
    assert _rel(xt.grad.numpy(), g_j) <= 1e-4
