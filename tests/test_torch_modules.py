"""The port's generator blocks (segan_pytorch_tpu_torch/models) against the flax blocks of
segan_pytorch_tpu, with the same random weights carried over by
generator_state_from_jax and the same numpy inputs.

Weights are drawn at scale 1/sqrt(K*Cin) and PReLU slopes in U(0, 0.3), so outputs are
O(1) and the negative branch is exercised (a fresh block has every slope at 0).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models import generator as jgen
from segan_pytorch_tpu.models import modules as jmod
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu_torch.models import generator as tgen
from segan_pytorch_tpu_torch.models import modules as tmod
from segan_pytorch_tpu_torch.utils.checkpoint import generator_state_from_jax

TOL = 1e-5  # fp32 per block: XLA at HIGHEST vs torch's CPU convs, summed in other orders
KEY = jax.random.PRNGKey(0)


def _randomize(params, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_tree(params).items():
        if path.endswith("act/weight"):
            out[path] = rng.uniform(0, 0.3, v.shape)
        elif v.ndim == 3:  # (K, Cin, Cout)
            out[path] = rng.randn(*v.shape) / np.sqrt(v.shape[0] * v.shape[1])
        elif path.endswith("skip_k"):
            out[path] = rng.uniform(0.5, 1.5, v.shape)
        else:
            out[path] = rng.randn(*v.shape) * 0.1
    return {k: v.astype(np.float32) for k, v in out.items()}


def _port_block(block, flat, group):
    """Load one block's JAX leaves into the port block via the generator converter."""
    sd = generator_state_from_jax({f"{group}/{k}": v for k, v in flat.items()})
    head, _, idx = group.rpartition("_")
    prefix = f"{head}.{idx}." if head in ("enc_blocks", "dec_blocks") else f"{group}."
    block.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return block.eval()


def _x(B, T, C, seed=0):
    return np.random.RandomState(seed).randn(B, T, C).astype(np.float32)


def _t(x):  # (B, T, C) numpy -> port (B, C, T)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _n(t):  # port (B, C, T) -> (B, T, C) numpy
    return t.detach().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("stride", [4, 1])
@pytest.mark.parametrize("use_bias", [True, False])
def test_gconv1d_block(stride, use_bias):
    x = _x(2, 256, 6)
    jb = jmod.GConv1DBlock(6, 10, 31, stride=stride, use_bias=use_bias)
    flat = _randomize(jb.init(KEY, jnp.asarray(x))["params"], seed=1)
    h_j, a_j = jb.apply({"params": unflatten_tree(flat)}, jnp.asarray(x), ret_linear=True)
    tb = _port_block(tmod.GConv1DBlock(6, 10, 31, stride=stride, use_bias=use_bias),
                     flat, "enc_blocks_0")
    with torch.no_grad():
        h, a = tb(_t(x), ret_linear=True)
    np.testing.assert_allclose(_n(h), np.asarray(h_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_n(a), np.asarray(a_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act", [None, "Tanh"])
def test_gdeconv1d_block(act):
    """Deconv padding max(0, (4-31)//-2) = 13, the odd-K trim and the always-present
    deconv bias, then PReLU or Tanh."""
    x = _x(2, 16, 12, seed=2)
    jb = jmod.GDeconv1DBlock(12, 6, 31, stride=4, act=act)
    flat = _randomize(jb.init(KEY, jnp.asarray(x))["params"], seed=3)
    assert "deconv/bias" in flat
    y_j = jb.apply({"params": unflatten_tree(flat)}, jnp.asarray(x))
    tb = _port_block(tmod.GDeconv1DBlock(12, 6, 31, stride=4, act=act), flat,
                     "dec_blocks_0")
    with torch.no_grad():
        y = tb(_t(x))
    assert y.shape == (2, 6, 64)
    np.testing.assert_allclose(_n(y), np.asarray(y_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("skip_type", ["alpha", "constant", "conv"])
@pytest.mark.parametrize("merge", ["sum", "concat"])
def test_gskip(skip_type, merge):
    hj, hi = _x(2, 64, 8, seed=4), _x(2, 64, 8, seed=5)
    js = jgen.GSkip(skip_type, 8, merge_mode=merge, kwidth=11, use_bias=True)
    flat = _randomize(js.init(KEY, jnp.asarray(hj), jnp.asarray(hi))["params"], seed=6)
    y_j = js.apply({"params": unflatten_tree(flat)}, jnp.asarray(hj), jnp.asarray(hi))
    ts = _port_block(tgen.GSkip(skip_type, 8, merge_mode=merge, kwidth=11,
                                use_bias=True), flat, "alpha_0")
    with torch.no_grad():
        y = ts(_t(hj), _t(hi))
    np.testing.assert_allclose(_n(y), np.asarray(y_j), rtol=TOL, atol=TOL)


def test_constant_skip_is_frozen_and_alpha_learns():
    assert not tgen.GSkip("constant", 4).skip_k.requires_grad
    assert tgen.GSkip("alpha", 4).skip_k.requires_grad


@pytest.mark.parametrize("norm", ["bnorm", "snorm"])
def test_both_blocks_build_with_each_norm(norm):
    """bnorm gives GConv1DBlock and GDeconv1DBlock a BatchNorm1d 'norm' (held against JAX
    in test_torch_discriminator.py and test_torch_bnorm_g.py); snorm normalises both
    blocks' weights (held against JAX in test_torch_wsegan_models.py)."""
    if norm == "bnorm":
        blk = tmod.GConv1DBlock(4, 8, 31, stride=4, norm_type=norm)
        assert isinstance(blk.norm, tmod.BatchNorm1d)
        dec = tmod.GDeconv1DBlock(8, 4, 31, stride=4, norm_type=norm, act="Tanh")
        assert isinstance(dec.norm, tmod.BatchNorm1d) and dec.norm.weight.shape == (4,)
        assert {n for n, _ in dec.named_buffers()} == {
            "norm.running_mean", "norm.running_var", "norm.num_batches_tracked"}
        with pytest.raises(TypeError):
            tmod.GDeconv1DBlock(8, 4, 31, stride=4, norm_type="lnorm")
    else:
        blk = tmod.GConv1DBlock(4, 8, 31, stride=4, norm_type=norm)
        assert blk.norm is None and blk.conv.snorm
        assert {n for n, _ in blk.conv.named_buffers()} == {"weight_u", "weight_v"}
        dec = tmod.GDeconv1DBlock(8, 4, 31, stride=4, norm_type=norm)
        assert dec.deconv.weight_orig.shape == (8, 4, 31)
        assert dec.deconv.weight_v.shape == (8 * 31,)


def test_seeded_init_has_the_reference_statistics():
    """N(0, 0.02) conv weights, zero conv bias, PReLU slopes 0, and torch's default
    U(+-1/sqrt(Cout*K)) for the deconv weight and bias."""
    g = torch.Generator().manual_seed(0)
    enc = tmod.GConv1DBlock(64, 128, 31, stride=4, generator=g)
    dec = tmod.GDeconv1DBlock(256, 64, 31, stride=4, generator=g)
    with torch.no_grad():
        assert abs(float(enc.conv.weight.std()) - 0.02) < 1e-3
        assert float(enc.conv.bias.abs().max()) == 0.0
        assert float(enc.act.weight.abs().max()) == 0.0
        bound = 1.0 / np.sqrt(64 * 31)
        for p in (dec.deconv.weight, dec.deconv.bias):
            assert float(p.abs().max()) <= bound
        # U(-b, b) has std b/sqrt(3); 500k samples put it within 1%
        assert abs(float(dec.deconv.weight.std()) * np.sqrt(3) / bound - 1) < 0.01
    again = tmod.GConv1DBlock(64, 128, 31, stride=4,
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.conv.weight, enc.conv.weight)  # seeded: reproducible
