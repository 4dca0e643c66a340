"""The wgmma route of the port's fused conv + bias + PReLU
(segan_pytorch_tpu_torch/csrc/conv1d_wgmma.cu, ``conv1d_wgmma_kernel``), G's pitched pad
that feeds it, and the route rule among the wgmma, mma.sync and FMA kernels.

No card here: a float64 numpy emulation of exactly the kernel's index maps (x read through
its pitched rows by TMA boxes of 96 samples x 4 channels per m16 group, zero at or past
T_in and past Cin; the weights' taps permuted by the wrapper and read 32 bytes a 16-deep
step; each lane's A fragments loaded from the staged window; ring stages of 4 channels,
split-K slices of whole stages summed in the epilogue's order; each warp's m16 group
stored) is held against the plain version at full SEGAN+ width and against the JAX Pallas
kernel in interpret mode. On the card chip_smoke.py holds the kernel itself against the
plain version. Small-row shapes keep mma.sync, whose emulation is
tests/test_torch_conv1d_mma.py's.
"""
import gc
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from segan_pytorch_tpu.ops.conv import reflect_pad_1d as jax_reflect_pad_1d
from segan_pytorch_tpu.ops.pallas import conv1d as plconv
from segan_pytorch_tpu_torch.models import modules
from segan_pytorch_tpu_torch.models.generator import Generator
from segan_pytorch_tpu_torch.ops import conv as conv_ops
from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

# conv1d_wgmma_kernel's constants, as in csrc/conv1d_wgmma.cu
BN, CC, WIN, STAGES, CONSUMERS = 128, 4, 96, 4, 2
H100_SMS = 132
T, KW = 16384, 31
CHANS = [1, 64, 128, 256, 512, 1024]
BATCHES = [1, 6, 8, 64, 128, 150, 300]
# the wgmma route's tap order, column 16 h + k of a channel's permuted weights: at
# contraction index k = 2q + e and 2q + 8 + e (lane quad q, e = 0, 1), step h takes the
# taps 8q + 4h + e and 8q + 4h + 2 + e
WGMMA_TAPS = tuple(8 * (k % 8 // 2) + 4 * h + k % 2 + 2 * (k // 8)
                   for h in range(2) for k in range(16))


def _main_path(B, layer):
    """(B, Cin, T_in, Cout, T_out) of encoder layer `layer` (0-4) for B chunks."""
    t_out = T // 4 ** (layer + 1)
    return B, CHANS[layer], 4 * t_out + KW - 2, CHANS[layer + 1], t_out


def _a_index():
    """a_idx[h, r, k]: the window sample (from 4 t0) that row r of an m16 group takes at
    contraction index k of 16-deep step h, built lane by lane as the kernel loads it: lane
    (g, t) loads four samples from 4 g + 8 t + 4 h for row g and 32 on for row g + 8, and
    its registers {r0.x, r8.x, r0.y, r8.y} are the wgmma A fragment {(g, 2t..2t+1),
    (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9)}."""
    a_idx = np.full((2, 16, 16), -1)
    for h in range(2):
        for g in range(8):
            for t in range(4):
                r0 = 4 * g + 8 * t + 4 * h + np.arange(4)
                r8 = r0 + 4 * 8
                a_idx[h, g, 2 * t:2 * t + 2] = r0[:2]
                a_idx[h, g + 8, 2 * t:2 * t + 2] = r8[:2]
                a_idx[h, g, 2 * t + 8:2 * t + 10] = r0[2:]
                a_idx[h, g + 8, 2 * t + 8:2 * t + 10] = r8[2:]
    assert (a_idx >= 0).all() and a_idx.max() < WIN
    return a_idx


def _emulate_wgmma_kernel(x_buf, t_in, w, b, a, num_sms=H100_SMS, shift=0, w_perm=None):
    """What conv1d_wgmma_kernel computes, in float64 numpy: (y, pre) (B, Cout, T_out),
    NaN where no warp stores. x_buf is x's pitched buffer (B, Cin, pitch), of which TMA
    reads samples < t_in; w (Cout, Cin, K). `shift` moves every window by that many
    samples and `w_perm` replaces the wrapper's permuted weights (mutations the
    comparisons must catch)."""
    B, cin, pitch = x_buf.shape
    cout, _, k = w.shape
    t_out = (t_in - k) // 4 + 1
    assert pitch % 8 == 0 and pitch >= t_in and cout % BN == 0
    assert K._tensor_core_shape(torch.bfloat16, cout, k, 4, t_out)
    if w_perm is None:
        w_perm = K._wgmma_weights(torch.from_numpy(w)).numpy()
    m_tiles, splits = K._wgmma_plan(B, cin, cout, t_out, num_sms)
    per = -(-(-(-cin // splits)) // CC) * CC  # channels per slice: whole stages
    assert -(-cin // per) == splits
    M = B * t_out
    groups = M // 16
    gb, gt0 = np.divmod(np.arange(groups) * 16, t_out)  # group q: batch row, first step
    a_idx = _a_index()
    # the TMA box of group q: samples 4 t0 + j of x, 0 at or past t_in (the map's bound)
    samp = 4 * gt0[:, None] + shift + np.arange(WIN)[None, :]
    inside = (samp >= 0) & (samp < t_in)
    samp = np.clip(samp, 0, t_in - 1)
    partial = np.zeros((splits, M, cout))
    for z in range(splits):
        for c0 in range(z * per, min(cin, (z + 1) * per), CC):  # ring stages
            ch = c0 + np.arange(CC)
            live = ch < cin  # channels past Cin: TMA's zeros, in x and in w
            chc = np.minimum(ch, cin - 1)
            win = np.where(inside[:, None, :] & live[None, :, None],
                           x_buf[gb[:, None, None], chc[None, :, None], samp[:, None, :]],
                           0.0)  # (group, channel, sample)
            wst = np.where(live[None, :, None], w_perm[:, chc], 0.0)  # (Cout, channel, 32)
            for h in range(2):
                A = win[:, :, a_idx[h]]  # (group, channel, row, k)
                Bt = wst[:, :, 16 * h:16 * h + 16]  # the 32 bytes a step reads
                partial[z] += np.einsum("qcrk,nck->qrn", A, Bt).reshape(M, cout)
    acc = partial[0]
    for z in range(1, splits):  # the split-K epilogue's order
        acc = acc + partial[z]
    pre_rows = acc + (0.0 if b is None else b)
    y_rows = np.maximum(pre_rows, 0) + a * np.minimum(pre_rows, 0)
    y, pre = np.full((B, cout, t_out), np.nan), np.full((B, cout, t_out), np.nan)
    gpb = CONSUMERS * m_tiles * 4  # m16 groups per block
    for bx in range(-(-groups // gpb)):
        for wg in range(CONSUMERS):
            for i in range(m_tiles):
                for warp in range(4):
                    q = bx * gpb + wg * m_tiles * 4 + 4 * i + warp
                    if q >= groups:
                        continue
                    rows = slice(16 * q, 16 * q + 16)
                    steps = slice(gt0[q], gt0[q] + 16)
                    for n0 in range(0, cout, BN):  # every block column
                        ch = slice(n0, n0 + BN)
                        pre[gb[q], ch, steps] = pre_rows[rows, ch].T
                        y[gb[q], ch, steps] = y_rows[rows, ch].T
    return y, pre


def _pitched_inputs(B, cin, t_in, cout, bias=False, seed=0, tail=np.nan):
    """float64 inputs: x's pitched buffer (B, Cin, pitch) with `tail` past T_in (NaN: a
    kernel that read it would fail), w at 1/sqrt(K Cin), slopes U(0, 0.3)."""
    rng = np.random.RandomState(seed)
    pitch = -(-t_in // 8) * 8
    x_buf = np.full((B, cin, pitch), tail)
    x_buf[..., :t_in] = rng.randn(B, cin, t_in)
    w = rng.randn(cout, cin, KW) / np.sqrt(KW * cin)
    b = rng.randn(cout) * 0.1 if bias else None
    a = rng.uniform(0, 0.3, cout)
    return x_buf, t_in, w, b, a


def _check_against_plain(x_buf, t_in, w, b, a, **emulate):
    y, pre = _emulate_wgmma_kernel(x_buf, t_in, w, b, a, **emulate)
    t = lambda v: None if v is None else torch.from_numpy(v)
    y_ref, pre_ref = K.conv1d_prelu_plain(t(x_buf[..., :t_in]), t(w), t(b), t(a), 4)
    np.testing.assert_allclose(pre, pre_ref.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(y, y_ref.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("B,layer,num_sms", [
    (1, 1, H100_SMS),   # enc2, one chunk: split-K
    (2, 2, H100_SMS),   # enc3: 1 m64 tile per warpgroup, split-K
    (8, 3, H100_SMS),   # enc4: split-K over 256 channels
    (16, 4, H100_SMS),  # enc5: every block spans 16 chunks
    (4, 1, 16),         # enc2 with the 256-row block tile a 16-SM card gives
], ids=["enc2 B=1", "enc3 B=2", "enc4 B=8", "enc5 B=16", "enc2 B=4 16 SMs"])
def test_index_maps_match_plain_full_width(B, layer, num_sms):
    _, cin, t_in, cout, _ = _main_path(B, layer)
    _check_against_plain(*_pitched_inputs(B, cin, t_in, cout, seed=layer),
                         num_sms=num_sms)


def test_plans_cover_both_tiles_and_split_k():
    """The parametrised cases above reach both block tiles and both epilogues."""
    plans = {K._wgmma_plan(B, CHANS[l], CHANS[l + 1], T // 4 ** (l + 1), n)
             for B, l, n in [(1, 1, H100_SMS), (2, 2, H100_SMS), (8, 3, H100_SMS),
                             (16, 4, H100_SMS), (4, 1, 16)]}
    assert {m for m, _ in plans} == {1, 2}
    assert {s > 1 for _, s in plans} == {True, False}


@pytest.mark.parametrize("B,cin,t_in,cout,bias", [
    (3, 24, 91, 128, True),          # T_out 16: the zero tap of the last row reads x[91]
    (2, 6, 4 * 63 + 31, 256, True),  # Cin 6: the second stage reads channels 6, 7 as 0
    (5, 40, 4 * 47 + 31, 128, False),  # T_out 48: blocks across chunks, a partial one
], ids=["T_in=91", "Cin=6", "T_out=48"])
def test_index_maps_match_plain_at_the_edges_of_x(B, cin, t_in, cout, bias):
    """The buffer past T_in holds NaN: the kernel's windows must read 0 there."""
    assert (t_in - KW) % 4 == 0
    _check_against_plain(*_pitched_inputs(B, cin, t_in, cout, bias=bias, seed=B))


@pytest.mark.parametrize("shift", [1, -1])
def test_a_window_off_by_one_sample_fails(shift):
    with pytest.raises(AssertionError):
        _check_against_plain(*_pitched_inputs(*_main_path(1, 1)[:4], seed=11, tail=0.0),
                             shift=shift)


@pytest.mark.parametrize("mutation", ["padded, not permuted", "steps swapped",
                                      "two taps swapped"])
def test_a_wrong_tap_permutation_fails(mutation):
    x_buf, t_in, w, b, a = _pitched_inputs(*_main_path(1, 1)[:4], seed=12)
    perm = K._wgmma_weights(torch.from_numpy(w)).numpy()
    if mutation == "padded, not permuted":
        perm = K._pad_taps(torch.from_numpy(w)).numpy()
    elif mutation == "steps swapped":
        perm = np.concatenate([perm[..., 16:], perm[..., :16]], axis=-1)
    else:
        perm = perm.copy()
        perm[..., [2, 8]] = perm[..., [8, 2]]
    with pytest.raises(AssertionError):
        _check_against_plain(x_buf, t_in, w, b, a, w_perm=perm)


def test_wgmma_taps_are_the_mma_fragments_order():
    """The permuted taps are the mma.sync route's, step by step (test_torch_conv1d_mma's
    `_mma_taps`), and each lane's A loads take exactly them."""
    taps = np.asarray(WGMMA_TAPS).reshape(2, 16)
    assert sorted(taps.ravel()) == list(range(K.KP))
    a_idx = _a_index()
    for h in range(2):
        for r in range(16):
            assert list(a_idx[h, r] - 4 * r) == list(taps[h])
    w = torch.randn(3, 2, 31).bfloat16()
    perm = K._wgmma_weights(w)
    assert perm.shape == (3, 2, 32) and perm.is_contiguous()
    assert torch.equal(perm, K._pad_taps(w)[..., list(WGMMA_TAPS)])


@pytest.mark.parametrize("bias", [True, False])
def test_emulation_matches_pallas_interpret(bias):
    """The JAX kernel (interpret mode) on its own layout: x (B, T, C) reflect-padded as
    its block pads it, w (K, Cin, Cout); 128 output channels, T_out 64."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 256, 4).astype(np.float32)
    w = (rng.randn(KW, 4, 128) / np.sqrt(KW * 4)).astype(np.float32)
    b = (rng.randn(128) * 0.1).astype(np.float32)
    a = rng.uniform(0, 0.3, 128).astype(np.float32)
    x_p = np.asarray(jax_reflect_pad_1d(jnp.asarray(x), KW // 2 - 1, KW // 2))
    y_j, pre_j = plconv.fused_conv1d_prelu(
        jnp.asarray(x_p), jnp.asarray(w), jnp.asarray(b if bias else np.zeros_like(b)),
        jnp.asarray(a), 4, 256, True)
    # the port's pitched pad of the same x
    x_t = conv_ops.reflect_pad_pitched(torch.from_numpy(x.transpose(0, 2, 1)).double(),
                                       KW // 2 - 1, KW // 2)
    t_in = x_t.shape[-1]
    x_buf = torch.as_strided(x_t, (2, 4, x_t.stride(1)), x_t.stride()).numpy()
    y, pre = _emulate_wgmma_kernel(x_buf, t_in, w.transpose(2, 1, 0).astype(np.float64),
                                   b.astype(np.float64) if bias else None,
                                   a.astype(np.float64))
    assert pre.shape == (2, 128, 64)
    np.testing.assert_allclose(pre.transpose(0, 2, 1), np.asarray(pre_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.transpose(0, 2, 1), np.asarray(y_j), rtol=1e-5, atol=1e-5)


def test_emulated_constants_are_the_kernels():
    """Change the kernel's ring, tiles or windows only together with its emulation."""
    src = (build.CSRC_DIR / "conv1d_wgmma.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert [int(consts[n]) for n in ("BN", "CC", "WIN", "STAGES", "CONSUMERS")] == [
        BN, CC, WIN, STAGES, CONSUMERS]
    assert (K.WGMMA_BN, K.WGMMA_CC, K.WGMMA_TILES[torch.bfloat16]) == (BN, CC, (1, 2))
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in src
    assert "__grid_constant__" in src and '#include "tma_ring.cuh"' in src
    ring = (build.CSRC_DIR / "tma_ring.cuh").read_text()  # the ring's shared helpers
    assert "cp.async.bulk.tensor.2d" in ring and "cp.async.bulk.tensor.3d" in ring
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in ring


@pytest.mark.parametrize("T_x", [16384, 4096, 1024, 256, 64, 16, 8, 4, 2, 1, 13, 14, 15])
@pytest.mark.parametrize("pads", [(14, 15), (15, 15)], ids=["strided", "symmetric"])
def test_pitched_pad_equals_reflect_pad(T_x, pads):
    """At every main-path T (G's blocks see 16384 ... 16 samples, windows of 2048 reach
    enc5 with 8) and at T < pad, where the pad reflects again and again."""
    x = torch.randn(2, 3, T_x)
    got = conv_ops.reflect_pad_pitched(x, *pads)
    want = conv_ops.reflect_pad_1d(x, *pads)
    assert torch.equal(got, want)
    pitch = got.stride(1)
    assert got.stride() == (3 * pitch, pitch, 1) and pitch % 8 == 0
    assert pitch - got.shape[-1] < 8
    assert got.storage_offset() == 0
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_reflect_pad_1d(jnp.asarray(x.numpy().transpose(0, 2, 1)),
                                                   *pads)).transpose(0, 2, 1))


def test_pitched_pad_gradient_equals_reflect_pad_gradient():
    x = torch.randn(2, 3, 40, dtype=torch.float64, requires_grad=True)
    gy = torch.randn(2, 3, 40 + 29, dtype=torch.float64)
    (g1,) = torch.autograd.grad((conv_ops.reflect_pad_pitched(x, 14, 15) * gy).sum(), x)
    (g2,) = torch.autograd.grad((conv_ops.reflect_pad_1d(x, 14, 15) * gy).sum(), x)
    assert torch.equal(g1, g2)


def test_g_blocks_pass_pitched_views(monkeypatch):
    """G's encoder blocks hand the kernel's op x in rows whose pitch is a multiple of 8;
    the plain version and the backward take the view, and the forward equals one on
    contiguous pads."""
    seen = []
    real = modules.conv1d_prelu

    def spy(x, w, b, a, stride):
        seen.append((x.shape, x.stride()))
        return real(x, w, b, a, stride)

    G = Generator(1, [8, 16, 32], 31, [4, 4, 4], z_dim=32, use_bias=True,
                  generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 1024, 1)
    z = torch.randn(2, 1024 // 64, 32)
    monkeypatch.setattr(modules, "conv1d_prelu", spy)
    out = G(x, z)
    out.sum().backward()
    assert len(seen) == 3  # the three encoder blocks
    for shape, stride in seen:
        B, cin, t_in = shape
        assert t_in % 2 == 1 and stride[1] % 8 == 0 and stride == (cin * stride[1],
                                                                     stride[1], 1)
    monkeypatch.setattr(conv_ops, "reflect_pad_pitched", conv_ops.reflect_pad_1d)
    ref = G(x, z)
    assert torch.equal(out, ref)


def _cheapest_plan(B, cin, cout, t_out, sms=H100_SMS, dtype=torch.bfloat16):
    """The stated plan rule, by enumeration: every (m_tiles, splits) the dtype's kernel
    cuts, the cheapest under its model (WGMMA_COST, WGMMA_TF32_COST: waves of blocks x
    their slice, plus the split-K epilogue's partial sums)."""
    fp32 = dtype == torch.float32
    wave, channel, split, partial = K.WGMMA_TF32_COST if fp32 else K.WGMMA_COST
    cc = K.WGMMA_TF32_CC if fp32 else CC
    costs = {}
    for m_tiles in K.WGMMA_TILES[dtype]:
        for splits in range(1, K.WGMMA_MAX_SPLITS + 1):
            per = -(-(-(-cin // splits)) // cc) * cc
            if -(-cin // per) != splits:
                continue
            blocks = -(-B * t_out // (128 * m_tiles)) * (cout // BN) * splits
            costs[m_tiles, splits] = (-(-blocks // sms) * (wave + channel * m_tiles * per)
                                      + (splits > 1) * (split + partial * splits * B
                                                        * t_out * cout))
    return min(costs, key=lambda p: (costs[p], p))


def _expected_route(dtype, B, layer, pitched=True):
    """The rule as ``_route``'s docstring states it, at main-path shape (B, layer) with x
    in G's pitched rows (or in contiguous odd ones)."""
    _, cin, _, cout, t_out = _main_path(B, layer)
    rows = B * t_out
    if layer == 0:
        return "mma" if rows >= K.ENC1_MMA_MIN_ROWS[dtype] else "fma"
    if dtype == torch.bfloat16 and B == 1 and rows <= K.ROWS_MAX_ROWS:
        return "rows"
    if pitched and (rows >= K.WGMMA_MIN_ROWS[dtype]
                    or rows * cout * cin >= K.WGMMA_MIN_WORK[dtype]):
        return "wgmma"
    return "mma"


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("layer", range(5), ids=[f"enc{i + 1}" for i in range(5)])
def test_route_rule_at_every_main_path_shape(B, layer):
    _, cin, _, cout, t_out = _main_path(B, layer)
    for dtype in (torch.bfloat16, torch.float32):
        assert K._route(dtype, B, cin, cout, KW, 4, t_out, pitched=True) == (
            _expected_route(dtype, B, layer))
        # x in contiguous odd rows: never wgmma
        assert K._route(dtype, B, cin, cout, KW, 4, t_out, pitched=False) == (
            "mma" if _expected_route(dtype, B, layer) == "wgmma"
            else _expected_route(dtype, B, layer))
    if _expected_route(torch.bfloat16, B, layer) == "wgmma":
        assert K._wgmma_plan(B, cin, cout, t_out, H100_SMS) == _cheapest_plan(
            B, cin, cout, t_out)
    if layer > 0:  # mma.sync's plan, as before
        warps_m, splits = K._mma_plan(B, cin, cout, t_out, H100_SMS)
        assert warps_m == {128: 2}.get(cout, 1) or (cout == 128 and B * t_out <= 64)


def test_route_rule_pins():
    """The thresholds the rule's docstring states, and what they give: G's bf16 encoder
    from 32 chunks on wgmma from enc2 on, below it where a layer has 1024 rows (enc2 from
    one chunk, enc3 from 4, enc4 from 16), on the rows route at one chunk (enc3-5: up to
    ROWS_MAX_ROWS rows of one batch row), mma.sync elsewhere; G's fp32 encoder on wgmma
    from enc2 on from 4 chunks, on mma.sync below; enc1 on the FMA kernel up to 16 chunks
    in bf16 and 32 in fp32, on mma.sync from 32 and 64."""
    assert (K.WGMMA_MIN_ROWS, K.WGMMA_MIN_WORK) == (
        {torch.bfloat16: 1 << 10, torch.float32: 1 << 13},
        {torch.bfloat16: 1 << 28, torch.float32: 1 << 25})
    assert K.ENC1_MMA_MIN_ROWS == {torch.bfloat16: 1 << 17, torch.float32: 1 << 18}
    want = {1: ["wgmma", "rows", "rows", "rows"], 4: ["wgmma", "wgmma", "mma", "mma"],
            8: ["wgmma", "wgmma", "mma", "mma"], 16: ["wgmma", "wgmma", "wgmma", "mma"],
            32: ["wgmma"] * 4, 64: ["wgmma"] * 4, 300: ["wgmma"] * 4}
    for B, routes in want.items():
        assert [_expected_route(torch.bfloat16, B, l) for l in range(1, 5)] == routes, B
    for B in (1, 2, 4, 6, 8, 16, 64, 150, 300):
        assert [_expected_route(torch.float32, B, l) for l in range(1, 5)] == (
            ["wgmma"] * 4 if B >= 4 else ["mma"] * 4), B
    assert [_expected_route(torch.bfloat16, B, 0) for B in (1, 16, 32, 300)] == [
        "fma", "fma", "mma", "mma"]
    assert [_expected_route(torch.float32, B, 0) for B in (1, 32, 64, 300)] == [
        "fma", "fma", "mma", "mma"]


class _FakeLib:
    def __init__(self):
        self.calls = []

    def entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(K, "_entries", lambda: tuple(
        lib.entry(n) for n in ("fma", "splits", "mma", "tf32")))
    monkeypatch.setattr(K, "_wgmma_entry", lambda dtype=torch.bfloat16: lib.entry(
        "wgmma_tf32" if dtype == torch.float32 else "wgmma"))
    monkeypatch.setattr(K, "_rows_entries", lambda: (lib.entry("rows_encode"),
                                                      lib.entry("rows")))
    monkeypatch.setattr(K, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(K, "_records", {})  # records hold the entry points they call
    monkeypatch.setattr(K, "_current_device", lambda: None)  # x's index on the CPU
    monkeypatch.setattr(K, "_current_stream", lambda index: 0)
    return lib


def _bf16_layer(B, layer, pitched=True, seed=0):
    _, cin, t_in, cout, t_out = _main_path(B, layer)
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((B, cin, t_in - 29), generator=g).bfloat16()
    x = (conv_ops.reflect_pad_pitched if pitched else conv_ops.reflect_pad_1d)(h, 14, 15)
    w = torch.randn((cout, cin, KW), generator=g).bfloat16()
    a = torch.rand((cout,), generator=g).bfloat16()
    return x, w, a, t_out


def test_launch_dispatches_the_wgmma_route(fake_lib):
    """Without a card: a pitched bf16 main-path call reaches the wgmma entry with the
    permuted weights, its plan and the pitch, and counts in launches, launches_mma and
    launches_wgmma; force="mma" and force="fma" take the other kernels on the same view."""
    x, w, a, t_out = _bf16_layer(64, 2)
    before = (K.launches, K.launches_mma, K.launches_tf32, K.launches_wgmma)
    K._launch(x, w, None, a, 4, t_out)
    name, args = fake_lib.calls[-1]
    assert name == "wgmma"
    assert args[0] == x.data_ptr() and args[1] == K._permuted_weights(w).data_ptr()
    assert args[7:9] == K._wgmma_plan(64, 128, 256, t_out, H100_SMS)
    assert args[9:14] == (64, 128, x.shape[2], x.stride(1), 256)
    assert (K.launches, K.launches_mma, K.launches_tf32, K.launches_wgmma) == (
        before[0] + 1, before[1] + 1, before[2], before[3] + 1)
    K._launch(x, w, None, a, 4, t_out, force="mma")
    name, args = fake_lib.calls[-1]
    assert name == "mma" and args[1] == K._padded_weights(w).data_ptr()
    assert args[11:13] == (x.shape[2], x.stride(1))  # T_in, pitch
    fake_lib.calls.clear()
    K._launch(x, w, None, a, 4, t_out, force="fma")
    assert [n for n, _ in fake_lib.calls] == ["splits", "fma"]
    assert fake_lib.calls[-1][1][11:13] == (x.shape[2], x.stride(1))
    assert (K.launches, K.launches_mma, K.launches_wgmma) == (
        before[0] + 3, before[1] + 2, before[3] + 1)


def test_odd_pitch_takes_mma_sync(fake_lib):
    """x in contiguous odd rows, and a view whose pitch is not a multiple of 8, take
    mma.sync (a route by layout, decided before launch); forcing wgmma on them raises and
    launches nothing."""
    x, w, a, t_out = _bf16_layer(64, 2, pitched=False)
    assert x.is_contiguous() and x.shape[2] % 2 == 1
    buf = torch.zeros(64, 128, x.shape[2] + 2, dtype=torch.bfloat16)
    odd = buf[..., :x.shape[2]]
    assert odd.stride(1) % 8 != 0
    for xv in (x, odd):
        K._launch(xv, w, None, a, 4, t_out)
        assert fake_lib.calls[-1][0] == "mma"
        n = (K.launches, len(fake_lib.calls))
        with pytest.raises(ValueError, match="wgmma"):
            K._launch(xv, w, None, a, 4, t_out, force="wgmma")
        assert (K.launches, len(fake_lib.calls)) == n


def test_other_layouts_are_refused(fake_lib):
    """No kernel reads x but in rows of one pitch: nothing copies it silently."""
    x, w, a, t_out = _bf16_layer(8, 2)
    n = (K.launches, len(fake_lib.calls))
    for bad in (x.transpose(0, 1).contiguous().transpose(0, 1),  # batch rows interleaved
                x.contiguous()[::2]):                             # every other batch row
        with pytest.raises(ValueError, match="pitch"):
            K._launch(bad, w, None, a, 4, t_out)
    with pytest.raises(ValueError, match="route"):
        K._launch(x, w, None, a, 4, t_out, force="tensor cores")
    assert (K.launches, len(fake_lib.calls)) == n


def test_permuted_weights_follow_the_weight_and_version(monkeypatch):
    """Made once per weight and version; rebuilt after an optimizer step in place; under
    CUDA graph capture neither read nor written (a stale entry would feed every replay
    the weights of capture time)."""
    w = torch.nn.Parameter(torch.randn(128, 8, 31).bfloat16())
    wp = K._permuted_weights(w)
    assert torch.equal(wp, K._wgmma_weights(w)) and K._permuted_weights(w) is wp
    w.grad = torch.randn_like(w)
    torch.optim.SGD([w], lr=0.1).step()
    wp2 = K._permuted_weights(w)
    assert wp2 is not wp and torch.equal(wp2, K._wgmma_weights(w))
    monkeypatch.setattr(K, "_capturing", lambda: True)
    entry, n = K._permuted[w], len(K._permuted)
    with torch.no_grad():
        w.mul_(2)
    during = K._permuted_weights(w)
    assert torch.equal(during, K._wgmma_weights(w)) and during is not wp2
    assert K._permuted[w] is entry and len(K._permuted) == n  # the cache untouched
    monkeypatch.setattr(K, "_capturing", lambda: False)
    after = K._permuted_weights(w)
    assert after is not wp2 and torch.equal(after, K._wgmma_weights(w))
    n = len(K._permuted)
    del w, wp, wp2, during, after, entry
    gc.collect()
    assert len(K._permuted) == n - 1


def test_library_builds_each_source_on_its_own(monkeypatch, tmp_path):
    """csrc/conv1d_wgmma.cu is a library of its own; the split-K header it shares with
    conv1d_prelu.cu is hashed into both names."""
    for f in build.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = {n: build.library_path(n) for n in ("conv1d_prelu", "conv1d_wgmma")}
    assert before["conv1d_prelu"] != before["conv1d_wgmma"]
    (tmp_path / "splitk_epilogue.cuh").write_text("// edited\n")
    assert all(build.library_path(n) != p for n, p in before.items())
    cmd = build.nvcc_command("nvcc", "conv1d_wgmma", tmp_path / "x.so")
    assert cmd[-1].endswith("conv1d_wgmma.cu") and "arch=compute_90a,code=sm_90a" in cmd


def test_the_compute_copy_keeps_the_weight_caches():
    """A bf16 engine's G copy is made with inference mode off even when infer_G makes it
    under inference mode: its weights keep version counters, so the kernel pads and
    permutes each once (an inference tensor would be padded and permuted on every call)."""
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    cfg = SEGANConfig(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4],
                      z_dim=32, no_bias=True, compute_dtype="bfloat16")
    seg = SEGAN(cfg, device="cpu")
    seg.infer_G(torch.randn(2, 1024, 1))
    ws = [blk.conv.get_weight() for blk in seg._G_compute.enc_blocks]
    assert all(w.dtype == torch.bfloat16 and not torch.is_inference(w) for w in ws)
    with torch.inference_mode():
        assert all(K._permuted_weights(w) is K._permuted_weights(w) for w in ws)
        assert all(K._padded_weights(w) is K._padded_weights(w) for w in ws)
