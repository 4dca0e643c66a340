"""The rest of the port's blocks (segan_pytorch_tpu_torch/models/modules.py: LayerNorm,
ResBlock1D, ResARModule, SincConv, CombFilter, PostProcessingCombNet, Conv1DResBlock and
pos_code) against the flax blocks of segan_pytorch_tpu, with the same random weights
carried over by ``module_state_from_jax`` and the same numpy inputs, in train and eval
mode where the two differ (a BatchNorm's statistics).

Weights are drawn at 1/sqrt(fan_in), PReLU slopes in U(0, 0.3), BatchNorm's scales and
running statistics away from their initial values, and ResBlock1D's skip_alpha in
U(0.5, 1.5), so every branch shows in the outputs. SincConv keeps its mel-spaced band
edges, moved by a few per cent, so that its filters stay band-passes.

Tolerance: TOL, the largest difference over the largest magnitude of the JAX output, in
fp32 (XLA at HIGHEST against torch's CPU ops, summed in other orders).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models import modules as jmod
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu_torch.models import modules as tmod
from segan_pytorch_tpu_torch.utils.checkpoint import module_state_from_jax
from test_torch_discriminator import randomize

TOL = 1e-5
KEY = jax.random.PRNGKey(0)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _x(B, T, C, seed):
    return np.random.RandomState(seed).randn(B, T, C).astype(np.float32)


def _t(x):  # (B, T, C) numpy -> port (B, C, T)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _n(t):  # port (B, C, T) -> (B, T, C) numpy
    return t.detach().float().numpy().transpose(0, 2, 1)


def _variables(jb, x, seed, train=False):
    """The JAX block's variables at O(1) scale, flattened, with skip_alpha in U(0.5, 1.5)
    and the SincConv band edges scaled by U(0.95, 1.05)."""
    flat = randomize(dict(jb.init(KEY, jnp.asarray(x), train=train)
                          if train else jb.init(KEY, jnp.asarray(x))), seed)
    rng = np.random.RandomState(seed + 100)
    init = flatten_tree(dict(jb.init(KEY, jnp.asarray(x))))
    for k in flat:
        if k.endswith("skip_alpha"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
        elif k.endswith(("filt_b1", "filt_band")):
            flat[k] = (np.asarray(init[k]) * rng.uniform(0.95, 1.05, init[k].shape)
                       ).astype(np.float32)
    return flat


def _port(block, flat):
    block.load_state_dict(module_state_from_jax(block, flat), strict=True)
    return block


def _apply(jb, flat, x, train):
    """(output, new batch_stats or None) of the JAX block."""
    v = unflatten_tree(flat)
    if train and "batch_stats" in v:
        out, new = jb.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return out, flatten_tree(new["batch_stats"])
    if train:
        return jb.apply(v, jnp.asarray(x), train=True), None
    return jb.apply(v, jnp.asarray(x)), None


def _check_stats(tb, stats):
    for path, want in stats.items():
        got = tb.get_buffer(path.replace("/", "."))
        assert _rel(got.numpy(), want) <= TOL, path


def test_layer_norm():
    """(x - mean) / std over time per (batch, channel), std unbiased (ddof 1)."""
    x = (_x(2, 64, 6, seed=1) * 3 + 1).astype(np.float32)
    y_j = jmod.LayerNorm().apply({}, jnp.asarray(x))
    with torch.no_grad():
        y = tmod.LayerNorm()(_t(x))
    assert _rel(_n(y), y_j) <= TOL
    assert float(y.std(dim=2, unbiased=True).sub(1).abs().max()) < 1e-5


RES_CASES = [(None, 1, False), (None, 2, False), ("bnorm", 1, False),
             ("bnorm", 1, True), ("bnorm", 2, False), ("bnorm", 2, True)]


@pytest.mark.parametrize("norm,dilation,train", RES_CASES)
def test_res_block_1d(norm, dilation, train):
    """entry 1x1 -> [norm] -> ReLU -> dilated K=5 over a reflect pad -> [norm] -> ReLU ->
    exit 1x1 -> [norm]; ReLU(skip_alpha x + h); in train mode the running statistics of
    all three norms."""
    x = _x(3, 64, 6, seed=2)
    jb = jmod.ResBlock1D(6, 10, 5, dilation=dilation, norm_type=norm)
    flat = _variables(jb, x, seed=3, train=norm == "bnorm")
    y_j, stats = _apply(jb, flat, x, train)
    tb = _port(tmod.ResBlock1D(6, 10, 5, dilation=dilation, norm_type=norm), flat)
    tb.train(train)
    with torch.no_grad():
        y = tb(_t(x))
    assert y.shape == (3, 6, 64)
    assert _rel(_n(y), y_j) <= TOL
    if stats:
        _check_stats(tb, stats)


@pytest.mark.parametrize("norm,train", [(None, False), ("bnorm", False), ("bnorm", True)])
def test_res_ar_module(norm, train):
    """Causal pad (K - 1) d, the dilated conv, [norm], PReLU; (x + skip, res)."""
    x = _x(2, 48, 6, seed=4)
    jb = jmod.ResARModule(6, 12, 8, 3, 2, norm_type=norm)
    flat = _variables(jb, x, seed=5, train=norm == "bnorm")
    (y_j, r_j), stats = _apply(jb, flat, x, train)
    tb = _port(tmod.ResARModule(6, 12, 8, 3, 2, norm_type=norm), flat)
    tb.train(train)
    with torch.no_grad():
        y, r = tb(_t(x))
    assert y.shape == (2, 6, 48) and r.shape == (2, 8, 48)
    assert _rel(_n(y), y_j) <= TOL
    assert _rel(_n(r), r_j) <= TOL
    if stats:
        _check_stats(tb, stats)


def test_res_ar_module_is_causal():
    """An output sample depends on no later input sample."""
    tb = tmod.ResARModule(4, 8, 4, 3, 2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tb.act.weight.uniform_(0, 0.3)
        x = torch.randn(1, 4, 32)
        x2 = x.clone()
        x2[:, :, 20:] += 1.0
        (y, r), (y2, r2) = tb(x), tb(x2)
    torch.testing.assert_close(y[:, :, :20], y2[:, :, :20], rtol=0, atol=0)
    torch.testing.assert_close(r[:, :, :20], r2[:, :, :20], rtol=0, atol=0)
    assert float((r[:, :, 20:] - r2[:, :, 20:]).abs().max()) > 0


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_sinc_conv(padding):
    """The bank of 8 filters of 251 taps, one input channel, both paddings; and the
    gradients of the band edges."""
    x = (_x(2, 1024, 1, seed=6) * 0.3).astype(np.float32)
    jb = jmod.SincConv(8, 251, 16e3, padding=padding)
    flat = _variables(jb, x, seed=7)
    y_j = jb.apply(unflatten_tree(flat), jnp.asarray(x))
    tb = _port(tmod.SincConv(8, 251, 16e3, padding=padding), flat)
    y = tb(_t(x))
    assert y.shape == (2, 8, 1024 if padding == "SAME" else 1024 - 250)
    assert _rel(_n(y), y_j) <= TOL
    g = np.random.RandomState(8).randn(*np.asarray(y_j).shape).astype(np.float32)
    g_j = jax.grad(lambda p: jnp.sum(jb.apply({"params": p}, jnp.asarray(x)) * g))(
        unflatten_tree(flat)["params"])
    (y * _t(g)).sum().backward()
    for name in ("filt_b1", "filt_band"):
        assert _rel(getattr(tb, name).grad.numpy(), g_j[name]) <= 1e-4, name


def test_sinc_conv_init_is_mel_spaced():
    """Upstream's mel init: low cuts from 30 Hz, the last band up to fs / 2 - 100."""
    tb = tmod.SincConv(32, 251, 16e3)
    b1 = tb.filt_b1.detach().double().numpy() * 16e3
    b2 = b1 + tb.filt_band.detach().double().numpy() * 16e3
    assert abs(b1[0] - 30) < 1e-3 and abs(b2[-1] - 7900) < 1e-2
    assert np.all(np.diff(b1) > 0) and np.all(tb.filt_band.detach().numpy() > 0)
    init = jmod.SincConv(32, 251, 16e3, padding="SAME").init(KEY, jnp.zeros((1, 512, 1)))
    for name in ("filt_b1", "filt_band"):
        np.testing.assert_array_equal(getattr(tb, name).detach().numpy(),
                                      np.asarray(init["params"][name]))


def _jax_bank(flat, dtype):
    """The JAX SincConv's fp32 bank (F, K) from its parameters rounded to `dtype`: the
    VALID conv of K one-hot fp32 rows reads out each tap."""
    jb = jmod.SincConv(8, 251, 16e3)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype).astype(jnp.float32),
                          unflatten_tree(flat)["params"])
    out = jb.apply({"params": params}, jnp.eye(251, dtype=jnp.float32)[:, :, None])
    return np.asarray(out)[:, 0, :].T


def _bf16_bank(b1, band, N=251, fs=16e3):
    """SincConv's bank computed in bf16 from start to end: the wrong way."""
    t_right = (torch.linspace(1, (N - 1) / 2, (N - 1) // 2) / fs).bfloat16()
    beg = b1.abs() + 50.0 / fs
    end = beg + (band.abs() + 50.0 / fs)

    def low_pass(f):
        arg = 2 * math.pi * (f * fs)[:, None] * t_right[None, :]
        y = torch.sin(arg) / arg
        ones = torch.ones((f.shape[0], 1), dtype=torch.bfloat16)
        return 2 * f[:, None] * torch.cat([y.flip(1), ones, y], dim=1)

    bp = low_pass(end) - low_pass(beg)
    bp = bp / bp.amax(dim=1, keepdim=True)
    n = torch.linspace(0, N, N).bfloat16()
    return bp * (0.54 - 0.46 * torch.cos(2 * math.pi * n / N))


def test_sinc_bank_from_bf16_parameters():
    """A bf16 copy's bank is built in fp32 from the bf16 parameters: the sines take fp32
    arguments (~400 rad at the top band). The conv runs in fp32 too and only the output
    is cast to x's dtype. (The JAX package's own bf16 bank rounds 2 pi and 50 / fs to
    bf16 first, and its bf16 D then refuses to convolve the fp32 bank with bf16 x.) The
    same bank built in bf16 throughout is far off: the control."""
    x = _x(1, 512, 1, seed=9)
    flat = _variables(jmod.SincConv(8, 251, 16e3), x, seed=10)
    tb = _port(tmod.SincConv(8, 251, 16e3), flat)
    want = _jax_bank(flat, jnp.bfloat16)
    with torch.no_grad():
        for p in tb.parameters():
            p.data = p.data.to(torch.bfloat16)
        got = tb.bank()
    assert got.dtype == torch.float32
    assert _rel(got[:, 0].numpy(), want) <= TOL
    # the bf16 parameters move the bank, which a fp32 bank shows
    assert _rel(want, _jax_bank(flat, jnp.float32)) > 10 * TOL
    # the control: the same bank built in bf16 throughout
    with torch.no_grad():
        bad = _bf16_bank(tb.filt_b1, tb.filt_band)
    assert _rel(bad.float().numpy(), got[:, 0].numpy()) > 1e-2
    xb = _t(x).to(torch.bfloat16)
    with torch.no_grad():
        y = tb(xb)
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.conv1d(xb.float(), got)
    assert _rel(y.float().numpy(), ref.numpy()) <= 2.0 ** -8  # the output's one rounding


@pytest.mark.parametrize("L", [2, 5])
def test_comb_filter(L):
    x = _x(2, 40, 3, seed=11)
    jb = jmod.CombFilter(3, 4, L)
    flat = _variables(jb, x, seed=12)
    y_j = jb.apply(unflatten_tree(flat), jnp.asarray(x))
    tb = _port(tmod.CombFilter(3, 4, L), flat)
    with torch.no_grad():
        y = tb(_t(x))
    assert y.shape == (2, 4, 40)
    assert _rel(_n(y), y_j) <= TOL


def test_comb_init_in_torch_layout():
    """weight (Cout, Cin, 2): tap 0 ~ U(0, 1), tap 1 = 1; no bias."""
    tb = tmod.CombFilter(3, 64, 4, generator=torch.Generator().manual_seed(0))
    w = tb.filt.weight.detach()
    assert w.shape == (64, 3, 2) and tb.filt.bias is None
    assert torch.all(w[:, :, 1] == 1)
    assert 0 <= float(w[:, :, 0].min()) and float(w[:, :, 0].max()) < 1
    assert abs(float(w[:, :, 0].mean()) - 0.5) < 0.05


def test_post_processing_comb_net():
    """Combs at L = 4, 8, 16, 32 (2 channels each), then the bias-free Linear 'W'."""
    x = _x(2, 96, 3, seed=13)
    jb = jmod.PostProcessingCombNet(3, 8)
    flat = _variables(jb, x, seed=14)
    assert "params/W/weight" in flat and "params/filts_3/filt/weight" in flat
    y_j = jb.apply(unflatten_tree(flat), jnp.asarray(x))
    tb = _port(tmod.PostProcessingCombNet(3, 8), flat)
    assert set(tb.state_dict()) == {f"filts.{i}.filt.weight" for i in range(4)} | {
        "W.weight"}
    with torch.no_grad():
        y = tb(_t(x))
    assert y.shape == (2, 1, 96)
    assert _rel(_n(y), y_j) <= TOL


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kwidth", [3, 5])
def test_conv1d_res_block(transpose, kwidth):
    """Stride 4 (transposed: up by 4) at dilations 1, 2, 4; for K = 3 the transposed
    stage's one-sample zero pad on the right."""
    x = _x(2, 32, 4, seed=15)
    kw = dict(kwidth=kwidth, dilations=(1, 2, 4), stride=4, transpose=transpose)
    jb = jmod.Conv1DResBlock(4, 8, **kw)
    flat = _variables(jb, x, seed=16)
    y_j = jb.apply(unflatten_tree(flat), jnp.asarray(x))
    tb = _port(tmod.Conv1DResBlock(4, 8, **kw), flat)
    with torch.no_grad():
        y = tb(_t(x))
    assert y.shape == tuple(np.asarray(y_j).transpose(0, 2, 1).shape)
    assert _rel(_n(y), y_j) <= TOL


def test_conv1d_res_block_k3_transposed_pads_with_zeros():
    """K = 3 transposed: the first stage's last sample is a zero (not the bias, as
    upstream's output_padding would give) before its PReLU."""
    tb = tmod.Conv1DResBlock(2, 4, kwidth=3, dilations=(1, 2), transpose=True,
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tb.convs[0].bias.fill_(0.5)
        h0 = tb.convs[0](torch.randn(1, 2, 8))
        assert h0.shape[-1] == 7 * 4 + 3
        seen = []
        hook = tb.acts[0].register_forward_hook(lambda m, i, o: seen.append(i[0]))
        tb(torch.randn(1, 2, 8))
        hook.remove()
    assert seen[0].shape[-1] == 7 * 4 + 3 + 1
    assert torch.all(seen[0][:, :, -1] == 0)


def test_pos_code():
    """Position chunk_pos * T + t; sin on the even channels, cos on the odd ones."""
    x = _x(3, 128, 8, seed=17)
    pos = np.array([0, 2, 5], np.int32)
    y_j = jmod.pos_code(jnp.asarray(pos), jnp.asarray(x))
    y = tmod.pos_code(torch.from_numpy(pos), _t(x))
    assert _rel(_n(y), y_j) <= TOL
    pe = tmod.pos_code(torch.tensor([1]), torch.zeros(1, 4, 3))
    torch.testing.assert_close(pe[0, 0], torch.sin(torch.arange(3.0, 6.0)))
    torch.testing.assert_close(pe[0, 1], torch.cos(torch.arange(3.0, 6.0)))
