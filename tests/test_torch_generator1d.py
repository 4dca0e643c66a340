"""The port's Generator1D (segan_pytorch_tpu_torch/models/generator1d.py) against the JAX
package's (segan_pytorch_tpu/models/generator1d.py) at toy width: every option of the
JAX test's list at pooling 4 and 2 and the rest of the options, eval mode, with the
same random variables carried over by ``generator1d_state_from_jax``, the same numpy
input and JAX's z passed in; snorm in train mode (u, v and the outputs after two
forwards); the hidden states; freeze_enc's gradients; the errors; dropout; the BiLSTM
alone through the bridge; the linterp edge; and the blocks that take the fused
conv + PReLU op.

The JAX variables are shaped by ``jax.eval_shape`` of the init and filled by numpy
(``snorm_randomize``: convs 1/sqrt(K Cin), PReLU slopes U(0, 0.3), spectral u and v near
the top singular pair), alpha skips U(0.5, 1.5). Tolerance: TOL, the largest difference
over the largest magnitude of the JAX output, in fp32 (XLA at HIGHEST against torch's CPU
ops, summed in other orders), as for the SEGAN+ G.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from segan_pytorch_tpu.models import generator1d as jg1d
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu_torch.models import generator1d as tg1d
from segan_pytorch_tpu_torch.utils.checkpoint import (_g1d_lstm_from_jax,
                                                      generator1d_state_from_jax)
from test_torch_wsegan_models import snorm_randomize

TOL = 5e-5
KEY = jax.random.PRNGKey(0)
RNGS = {"params": KEY, "z": KEY, "dropout": KEY}
WIDTH = dict(ninputs=1, enc_fmaps=[8, 16, 32], kwidth=31, z_dim=16)
X = np.random.RandomState(0).randn(2, 1024, 1).astype(np.float32)
SPK = np.array([1, 3])

# the options of tests/test_generator1d.py, in its order
JAX_TEST_OPTIONS = [
    {}, {"no_z": True}, {"rnn_core": True}, {"num_spks": 4}, {"linterp": True},
    {"use_pos_code": True}, {"post_proc": True}, {"out_gate": True},
    {"big_out_filter": True}, {"lnorm": True, "dropout": 0.2}, {"skip_blacklist": (0,)},
    {"skip_merge": "concat"}, {"aal": True}, {"aal_out": True}, {"convblock": True},
    {"snorm": True}, {"freeze_enc": True},
]
MORE_OPTIONS = [
    (2, {"z_all": True}), (4, {"pad_type": "reflect"}), (2, {"pad_type": "reflect"}),
    (4, {"skip_type": "conv"}), (4, {"skip_type": "constant"}), (2, {"post_skip": True}),
    (4, {"no_tanh": True}),
    (4, {"dec_fmaps": [16, 8, 8, 1], "up_poolings": [4, 4, 1, 4]}),
    (2, {"activations": "LeakyReLU", "dec_activations": ["ReLU", "PReLU", "Tanh"]}),
]
CASES = ([(p, kw) for p in (4, 2) for kw in JAX_TEST_OPTIONS] + MORE_OPTIONS)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _extra(kw):
    return {"spkid": SPK} if kw.get("num_spks") else {}


def _z(pool, kw, seed=1):
    shape = (2, 2, 16) if kw.get("rnn_core") else (2, 1024 // pool ** 3, 16)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def build(pool, seed=3, **kw):
    """(JAX model, its variables flattened, the port's model with them loaded)."""
    g = jg1d.Generator1D(pooling=pool, **WIDTH, **kw)
    extra = {k: jnp.asarray(v) for k, v in _extra(kw).items()}
    shapes = jax.eval_shape(lambda: g.init(RNGS, jnp.asarray(X), train=False, **extra))
    flat = snorm_randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                  dict(shapes)), seed)
    rng = np.random.RandomState(seed + 7)
    for k in flat:
        if k.endswith("skip_k") and flat[k].ndim == 1:
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    tg = tg1d.Generator1D(pooling=pool, **WIDTH, **kw)
    tg.load_state_dict(generator1d_state_from_jax(flat), strict=True)
    return g, flat, tg


def jax_apply(g, flat, z, kw, **more):
    """The JAX model's apply, jitted (one XLA compile a model is quicker than eager
    dispatch here)."""
    v = unflatten_tree({k: jnp.asarray(a) for k, a in flat.items()})
    extra = {k: jnp.asarray(a) for k, a in _extra(kw).items()}
    run = jax.jit(lambda v, x, z, e: g.apply(v, x, z=z, **e, **more))
    return run(v, jnp.asarray(X), jnp.asarray(z), extra)


def port_apply(tg, z, kw, **more):
    spk = torch.from_numpy(SPK) if kw.get("num_spks") else None
    return tg(torch.from_numpy(X), z=torch.from_numpy(z), spkid=spk, **more)


@pytest.mark.parametrize("pool,kw", CASES, ids=[f"p{p}-{sorted(kw)}" for p, kw in CASES])
def test_options_equal_jax(pool, kw):
    g, flat, tg = build(pool, **kw)
    z = _z(pool, kw)
    y_j = jax_apply(g, flat, z, kw, train=False)
    tg.eval()
    with torch.no_grad():
        y = port_apply(tg, z, kw)
    assert y.shape == X.shape
    assert _rel(y.numpy(), y_j) <= TOL, _rel(y.numpy(), y_j)


def test_snorm_train_mode_two_forwards():
    """One power iteration per train-mode forward: u, v and the outputs after two."""
    g, flat, tg = build(2, snorm=True)
    z = _z(2, {})
    tg.train()
    for _ in range(2):
        y_j, upd = jax_apply(g, flat, z, {}, train=True, mutable=["spectral"])
        flat.update(flatten_tree({"spectral": upd["spectral"]}))
        with torch.no_grad():
            y = port_apply(tg, z, {})
        assert _rel(y.numpy(), y_j) <= TOL
    want = generator1d_state_from_jax(flat)
    state = tg.state_dict()
    uv = [k for k in want if k.endswith(("weight_u", "weight_v"))]
    assert len(uv) == 2 * 6
    for k in uv:
        assert _rel(state[k].numpy(), want[k].numpy()) <= TOL, k


def test_hidden_states_equal_jax():
    g, flat, tg = build(4)
    z = _z(4, {})
    _, hall_j = jax_apply(g, flat, z, {}, train=False, ret_hid=True)
    with torch.no_grad():
        _, hall = port_apply(tg.eval(), z, {}, ret_hid=True)
    assert set(hall) == set(hall_j) == {"enc_0", "enc_1", "enc_2", "enc_zc", "dec_0",
                                        "dec_1", "dec_2", "z"}
    for k in hall:
        assert hall[k].shape == hall_j[k].shape, k
        assert _rel(hall[k].numpy(), hall_j[k]) <= TOL, k


@pytest.mark.parametrize("skip", [False, True])
def test_freeze_enc_gradients(skip):
    """The detach comes after the skips are taken: with skip=False the encoder's
    gradients are 0, with skips they flow through them; both equal JAX's."""
    kw = {"freeze_enc": True, "skip": skip}
    g, flat, tg = build(4, **kw)
    z = _z(4, kw)
    params = unflatten_tree({k: jnp.asarray(a) for k, a in flat.items()})["params"]

    def loss(p):
        y = g.apply({"params": p}, jnp.asarray(X), z=jnp.asarray(z), train=False)
        return jnp.mean(y ** 2)

    grads_j = flatten_tree(jax.jit(jax.grad(loss))(params))
    tg.eval()
    port_apply(tg, z, kw).square().mean().backward()
    want = generator1d_state_from_jax({f"params/{k}": v for k, v in grads_j.items()})
    enc = 0.0
    for name, p in tg.named_parameters():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        if name.startswith("gen_enc"):
            enc += float(grad.abs().sum())
        assert _rel(grad.numpy(), want[name].numpy()) <= TOL or (
            float(want[name].abs().max()) == 0 and float(grad.abs().max()) == 0), name
    assert (enc > 0) == skip


@pytest.mark.parametrize("kw,err,match", [
    ({"mlpconv": True}, NotImplementedError, "MLPconv"),
    ({"satt": True}, NotImplementedError, "satt"),
    ({"activations": "glu"}, NotImplementedError, "glu"),
])
def test_unreconstructable_options_raise(kw, err, match):
    with pytest.raises(err, match=match):
        jg1d.Generator1D(pooling=4, **WIDTH, **kw).init(RNGS, jnp.asarray(X))
    with pytest.raises(err, match=match):
        tg1d.Generator1D(pooling=4, **WIDTH, **kw)


def test_missing_spkid_raises():
    with pytest.raises(ValueError, match="spk ID"):
        jg1d.Generator1D(pooling=4, num_spks=4, **WIDTH).init(RNGS, jnp.asarray(X))
    with pytest.raises(ValueError, match="spk ID"):
        tg1d.Generator1D(pooling=4, num_spks=4, **WIDTH)(torch.from_numpy(X))


def test_dropout_rate_and_scale_from_the_generator():
    """In training each element is kept with probability 1 - p and scaled by 1 / (1 - p),
    the mask drawn from the generator given to forward; eval mode keeps all."""
    blk = tg1d.GBlock1D(4, 64, 31, act=None, dropout=0.25, pooling=2)
    x = torch.randn(8, 4, 2048, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, full = blk.eval()(x)
        blk.train()
        _, a = blk(x, torch.Generator().manual_seed(5))
        _, b = blk(x, torch.Generator().manual_seed(5))
        _, c = blk(x, torch.Generator().manual_seed(6))
    kept = a != 0
    assert abs(1 - float(kept.float().mean()) - 0.25) < 0.01
    torch.testing.assert_close(a[kept], full[kept] / 0.75, rtol=1e-6, atol=0)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bilstm_equals_flax_through_the_bridge():
    """flax's two OptimizedLSTMCells (gates i, f, g, o; input kernels without a bias,
    hidden kernels with one) against nn.LSTM(bidirectional) loaded by the bridge; h0 is
    z for each direction, the cells start at 0."""
    B, T, C, H = 3, 11, 10, 6
    rng = np.random.RandomState(9)
    x, h0 = rng.randn(B, T, C).astype(np.float32), rng.randn(2, B, H).astype(np.float32)
    jl = jg1d._BiLSTM(H)
    shapes = jax.eval_shape(lambda: jl.init(KEY, jnp.asarray(x), jnp.asarray(h0)))
    flat = {k: (rng.randn(*v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
            for k, v in flatten_tree(jax.tree_util.tree_map(
                lambda s: np.zeros(s.shape, s.dtype), dict(shapes))).items()}
    y_j = jl.apply(unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()}),
                   jnp.asarray(x), jnp.asarray(h0))
    tl = tg1d._BiLSTM(C, H)
    state = _g1d_lstm_from_jax({k[len("params/"):]: v for k, v in flat.items()})
    tl.load_state_dict({k[len("rnn_core."):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        y = tl(torch.from_numpy(x), torch.from_numpy(h0))
    assert y.shape == (B, T, 2 * H)
    assert _rel(y.numpy(), y_j) <= TOL


def test_linterp_first_sample_extrapolates_as_jax():
    """JAX weighs the first sample against the clipped lower index: on [1 .. 6] with
    pooling 2 it gives 0.75 where F.interpolate(align_corners=False) gives 1.0."""
    row = np.arange(1, 7, dtype=np.float32).reshape(1, 6, 1)
    jb = jg1d.GBlock1D(1, 1, 1, act=None, pooling=2, enc=False, linterp=True)
    v = {"params": {"conv": {"weight": jnp.ones((1, 1, 1))}}}
    y_j, _ = jb.apply(v, jnp.asarray(row))
    tb = tg1d.GBlock1D(1, 1, 1, act=None, pooling=2, enc=False, linterp=True)
    with torch.no_grad():
        tb.conv.weight.fill_(1.0)
        y, _ = tb(torch.from_numpy(row).transpose(1, 2))
    np.testing.assert_allclose(y.numpy()[0, 0], np.asarray(y_j)[0, :, 0], rtol=1e-6)
    assert float(y[0, 0, 0]) == pytest.approx(0.75)
    ref = F.interpolate(torch.from_numpy(row).transpose(1, 2), scale_factor=2,
                        mode="linear", align_corners=False)
    assert float(ref[0, 0, 0]) == pytest.approx(1.0)
    torch.testing.assert_close(y[..., 1:-1], ref[..., 1:-1])


@pytest.mark.parametrize("kw,calls", [({}, 3), ({"snorm": True}, 3),
                                      ({"lnorm": True}, 0), ({"dropout": 0.1}, 0),
                                      ({"activations": "ReLU"}, 0),
                                      ({"convblock": True}, 0)])
def test_prelu_encoder_blocks_take_the_fused_op(monkeypatch, kw, calls):
    """A PReLU encoder block with neither LayerNorm nor dropout runs conv1d_prelu (the
    hand-written kernel on a CUDA device): three a forward here; any other block takes
    the plain conv. The op's outputs are the block's."""
    seen, op = [], tg1d.conv1d_prelu

    def spy(x, w, b, a, stride):
        seen.append(stride)
        return op(x, w, b, a, stride)

    monkeypatch.setattr(tg1d, "conv1d_prelu", spy)
    G = tg1d.Generator1D(pooling=2, **WIDTH, **kw).eval()
    with torch.no_grad():
        y = G(torch.from_numpy(X), z=torch.from_numpy(_z(2, {})))
    assert y.shape == X.shape and torch.isfinite(y).all()
    assert seen == [2] * calls
