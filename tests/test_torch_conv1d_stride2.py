"""The stride-2 tensor-core routes of the port's fused conv + bias + PReLU (Generator1D's
encoder): the wgmma kernels at S = 2 (csrc/conv1d_wgmma.cu, csrc/conv1d_wgmma_tf32.cu),
which stage a TMA box of WIN_HALF samples for each 8-row half of an m16 group, the
mma.sync kernels at S = 2 (csrc/conv1d_prelu.cu), which stage a WG_S2-sample window per
group, the route rule at stride 2, and Generator1D's pitched pad that feeds them.

No card here: a float64 numpy emulation of exactly the kernels' index maps at stride 2
(each box's or window's coordinate from its first row, zero at or past T_in; each lane's
A loads, two 4-byte loads a row in bf16 since a row starts at sample 2 g + 8 t + 4 h,
built lane by lane; the weights as the kernels read them, the taps in the order they
take at stride 4; split-K slices summed in the epilogue's order; each half or group
stored at its coordinate) is held against the plain version at Generator1D's 11 layer
shapes and at the edges of x, and against the JAX Pallas kernel (stride 2 by
space-to-depth) in interpret mode. fp32 emulates the 3xTF32 split, whose products are
exact in float64. On the card chip_smoke.py phase 13 holds the kernels themselves.
"""
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from segan_pytorch_tpu.ops.pallas import conv1d as plconv
from segan_pytorch_tpu_torch.models import generator1d as tg1d
from segan_pytorch_tpu_torch.ops import conv as conv_ops
from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from test_torch_conv1d_tf32 import SPLIT_ERR, split
from test_torch_conv1d_wgmma import WGMMA_TAPS, fake_lib  # noqa: F401

S = 2
KW = 31
T = 16384
H100_SMS = 132
# the SEGAN v1 paper's Generator1D encoder (chip_smoke.py G1D_V1), padded by (15, 15)
G1D_CHANS = [1, 16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 1024]
# the kernels' constants, as in their sources (test_emulated_constants_are_the_kernels)
WIN_HALF = 48  # both wgmma kernels: samples per 8-row half and channel
CC = {"bfloat16": 4, "float32": 2}  # the wgmma kernels' input channels per ring stage
WG_S2 = 64  # the mma.sync kernels: samples per m16 group and channel


def _layer(B, i):
    """(B, Cin, T_in, Cout, T_out) of Generator1D's encoder layer i (0-10) at B chunks."""
    t_out = T >> (i + 1)
    return B, G1D_CHANS[i], 2 * t_out + 30, G1D_CHANS[i + 1], t_out


def _lane_maps(route, fp32):
    """[(box, off, cols)] for the 16- (bf16) or 8-deep (fp32) steps of an input channel,
    built lane by lane as the kernels load their A fragments at stride 2: row r of an
    m16 group takes at contraction index k the sample off[r, k] of its group's box
    box[r, k] (wgmma: one box a half; mma.sync: the group's one window), and the weights
    as the kernel reads them give column cols[k] (the bf16 wgmma kernel: of the permuted
    copy; the others: the padded taps)."""
    halves = route == "wgmma"
    steps = []

    def rows(p):  # (box, first sample) of rows g and g + 8 for a lane's sample p of row g
        return ((0, p), (1, p)) if halves else ((0, p), (0, p + 8 * S))

    if not fp32:  # m16n8k16: lane (g, t) holds (g, 2t..2t+1), (g+8, ..), (g, 2t+8..), (g+8, ..)
        for h in range(2):
            box, off = np.zeros((16, 16), int), np.full((16, 16), -1)
            for g in range(8):
                for t in range(4):
                    for hh, (bx, p) in enumerate(rows(S * g + 8 * t + 4 * h)):
                        r = g + 8 * hh
                        box[r] = bx
                        off[r, 2 * t:2 * t + 2] = p + np.arange(2)  # r.x: one 4-byte load
                        off[r, 2 * t + 8:2 * t + 10] = p + 2 + np.arange(2)  # r.y: another
            cols = (16 * h + np.arange(16) if halves
                    else np.asarray(WGMMA_TAPS[16 * h:16 * h + 16]))
            steps.append((box, off, cols))
    elif halves:  # wgmma k8 TF32: lane (g, t) holds (g, t), (g+8, t), (g, t+4), (g+8, t+4)
        for s in range(4):
            box, off = np.zeros((16, 8), int), np.full((16, 8), -1)
            for g in range(8):
                for t in range(4):
                    for hh, (bx, p) in enumerate(rows(S * g + 8 * s + t)):
                        box[g + 8 * hh] = bx
                        off[g + 8 * hh, [t, t + 4]] = p, p + 4
            steps.append((box, off, 8 * s + np.arange(8)))
    else:  # mma.sync m16n8k8 TF32: step 2h + s, one 8-byte load a row
        for h in range(2):
            for s in range(2):
                box, off = np.zeros((16, 8), int), np.full((16, 8), -1)
                cols = np.empty(8, int)
                for g in range(8):
                    for t in range(4):
                        for hh, (bx, p) in enumerate(rows(S * g + 8 * t + 4 * h + 2 * s)):
                            box[g + 8 * hh] = bx
                            off[g + 8 * hh, [t, t + 4]] = p, p + 1
                        cols[[t, t + 4]] = 8 * t + 4 * h + 2 * s + np.arange(2)
                steps.append((box, off, cols))
    for box, off, _ in steps:
        assert (off >= 0).all() and off.max() < (WIN_HALF if halves else WG_S2)
    return steps


def _emulate(x_buf, t_in, w, b, a, route, num_sms=H100_SMS, shift=0, wrong_half=False):
    """What the stride-2 kernel of `route` computes, in float64 numpy: (y, pre) (B, Cout,
    T_out), NaN where no warp stores. x_buf is x's pitched buffer (B, Cin, pitch), of
    which the kernel reads samples < t_in; float32 (fp32: the 3xTF32 split emulated) or
    float64 (bf16's index maps). `shift` moves every window by that many samples and
    `wrong_half` takes a second half's coordinate from its group's batch row (mutations
    the comparisons must catch)."""
    fp32 = x_buf.dtype == np.float32
    dtype = torch.float32 if fp32 else torch.bfloat16
    B, cin, pitch = x_buf.shape
    cout, _, k = w.shape
    t_out = (t_in - k) // S + 1
    M = B * t_out
    assert pitch % 8 == 0 and pitch >= t_in
    if route == "wgmma":
        assert K._wgmma_shape(dtype, cin, cout, k, S, t_out, True)
        rows_per_box, win_len, boxes_per_group = 8, WIN_HALF, 2
        _, splits = K._wgmma_plan(B, cin, cout, t_out, num_sms, dtype)
        cc = CC[str(dtype)[6:]]
        per = -(-(-(-cin // splits)) // cc) * cc  # channels per slice: whole ring stages
    else:
        assert K._tensor_core_shape(dtype, cout, k, S, t_out)
        rows_per_box, win_len, boxes_per_group = 16, WG_S2, 1
        _, splits = K._mma_plan(B, cin, cout, t_out, num_sms, S, dtype)
        per = -(-cin // splits)  # whole input channels
    assert -(-cin // per) == splits
    # each box's (or window's) coordinate: the batch row and time step of its first row
    n_box = M // rows_per_box
    first = np.arange(n_box) * rows_per_box
    bb, tt = np.divmod(first, t_out)
    if wrong_half:
        bb = np.where(np.arange(n_box) % 2 == 1, bb[np.arange(n_box) // 2 * 2], bb)
        tt = first - bb * t_out
    samp = S * tt[:, None] + shift + np.arange(win_len)[None, :]
    inside = (samp >= 0) & (samp < t_in)  # the map's bound, or the staged zeros
    win = np.where(inside[:, None, :],
                   x_buf[bb[:, None, None], np.arange(cin)[None, :, None],
                         np.clip(samp, 0, t_in - 1)[:, None, :]], 0).astype(x_buf.dtype)
    groups = -(-M // 16)
    gwin = np.full((groups * boxes_per_group, cin, win_len), np.nan, x_buf.dtype)
    gwin[:n_box] = win  # a half past M is not loaded: its rows are not stored either
    gwin = gwin.reshape(groups, boxes_per_group, cin, win_len)
    if fp32:
        w_rd = [v.numpy().astype(np.float64) for v in K._mma_weights(torch.from_numpy(w))]
    elif route == "wgmma":
        w_rd = [K._wgmma_weights(torch.from_numpy(w)).numpy()]
    else:
        w_rd = [K._pad_taps(torch.from_numpy(w)).numpy()]
    parts = split(gwin) if fp32 else (gwin,)  # x's (big, small) in fp32
    parts = [v.astype(np.float64) for v in parts]
    q = np.arange(groups)[:, None, None]
    partial = np.zeros((splits, groups * 16, cout))
    for box, off, cols in _lane_maps(route, fp32):
        # A (group, row, channel, k) of this step, and the weights' columns it meets
        A = [v[q, box[None], :, off[None]].transpose(0, 1, 3, 2) for v in parts]
        W = [v[:, :, cols] for v in w_rd]
        for z in range(splits):
            ch = slice(z * per, min(cin, (z + 1) * per))

            def prod(x_part, w_part):
                return (x_part[:, :, ch].reshape(groups * 16, -1)
                        @ w_part[:, ch].reshape(cout, -1).T)

            if fp32:  # the kernels' three products: small x big, big x small, big x big
                partial[z] += prod(A[1], W[0]) + prod(A[0], W[1]) + prod(A[0], W[0])
            else:
                partial[z] += prod(A[0], W[0])
    acc = partial[0]
    for z in range(1, splits):  # the split-K epilogue's order
        acc = acc + partial[z]
    pre_rows = acc + (0.0 if b is None else b)
    y_rows = np.maximum(pre_rows, 0) + a * np.minimum(pre_rows, 0)
    y, pre = np.full(B * cout * t_out, np.nan), np.full(B * cout * t_out, np.nan)
    for j in range(n_box):  # each half (group) at its coordinate, every channel
        idx = (bb[j] * cout * t_out + tt[j] + np.arange(cout)[:, None] * t_out
               + np.arange(rows_per_box)[None, :])
        keep = idx < y.size
        rows = slice(first[j], first[j] + rows_per_box)
        pre[idx[keep]] = pre_rows[rows].T[keep]
        y[idx[keep]] = y_rows[rows].T[keep]
    return y.reshape(B, cout, t_out), pre.reshape(B, cout, t_out)


def _inputs(B, cin, t_in, cout, bias=False, seed=0, tail=np.nan, fp32=False):
    """x's pitched buffer (B, Cin, pitch) with `tail` past T_in (NaN: a kernel that read
    it would fail), w at 1/sqrt(K Cin), slopes U(0, 0.3); float32 x and w in fp32."""
    rng = np.random.RandomState(seed)
    dt = np.float32 if fp32 else np.float64
    pitch = -(-t_in // 8) * 8
    x_buf = np.full((B, cin, pitch), tail, dt)
    x_buf[..., :t_in] = rng.randn(B, cin, t_in)
    w = (rng.randn(cout, cin, KW) / np.sqrt(KW * cin)).astype(dt)
    b = rng.randn(cout).astype(dt).astype(np.float64) * 0.1 if bias else None
    a = rng.uniform(0, 0.3, cout).astype(dt).astype(np.float64)
    return x_buf, t_in, w, b, a


def _check(x_buf, t_in, w, b, a, route, **emulate):
    """The emulation vs the plain version in float64 on the same values: bf16's index
    maps to 1e-10; fp32 within the split's bound, SPLIT_ERR times sum |x| |w| over each
    output's window, and within 1e-6 relative."""
    y, pre = _emulate(x_buf, t_in, w, b, a, route, **emulate)
    t = lambda v: None if v is None else torch.from_numpy(np.asarray(v)).double()
    x = x_buf[..., :t_in]
    y_ref, pre_ref = (v.numpy() for v in K.conv1d_prelu_plain(t(x), t(w), t(b), t(a), S))
    assert not np.isnan(pre).any() and not np.isnan(y).any(), "rows no warp stores"
    if x_buf.dtype == np.float64:
        np.testing.assert_allclose(pre, pre_ref, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(y, y_ref, rtol=1e-10, atol=1e-10)
        return
    bound = SPLIT_ERR * K.conv1d(t(np.abs(x)), t(np.abs(w)), None, S).numpy() + 1e-12
    for got, ref in ((y, y_ref), (pre, pre_ref)):
        assert (np.abs(got - ref) <= bound).all(), np.max(np.abs(got - ref) / bound)
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def _routes_of(i):
    """The tensor-core routes that take Generator1D's layer i with x in pitched rows."""
    _, cin, _, cout, t_out = _layer(1, i)
    return [r for r, ok in (
        ("wgmma", K._wgmma_shape(torch.float32, cin, cout, KW, S, t_out, True)),
        ("mma", K._tensor_core_shape(torch.float32, cout, KW, S, t_out))) if ok]


G1D_CASES = [(i, r) for i in range(11) for r in _routes_of(i)]


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("i,route", G1D_CASES, ids=[f"L{i + 1} {r}" for i, r in G1D_CASES])
def test_index_maps_match_plain_at_generator1d_shapes(i, route, fp32):
    """One chunk through each of the 11 layers, on every tensor-core route that takes it:
    mma.sync from the first layer, wgmma from the sixth (Cout 128); the last (T_out 8)
    on wgmma alone, its one m16 group half live."""
    B, cin, t_in, cout, _ = _layer(1, i)
    _check(*_inputs(B, cin, t_in, cout, seed=i, fp32=fp32), route)


def test_generator1d_cases_cover_the_plans():
    """The cases above reach both routes, split-K and the single slice, both layouts of a
    group (one window, two halves) and the mma.sync tiles 8 x 1 and 4 x 2."""
    assert {r for _, r in G1D_CASES} == {"wgmma", "mma"}
    assert ("wgmma", 10) in {(r, i) for i, r in G1D_CASES}
    assert ("mma", 10) not in {(r, i) for i, r in G1D_CASES}  # T_out 8
    mma = {K._mma_plan(*_layer(1, i)[:2], _layer(1, i)[3], _layer(1, i)[4], H100_SMS, S,
                       dt) for i, r in G1D_CASES if r == "mma"
           for dt in (torch.bfloat16, torch.float32)}
    assert {m for m, _ in mma} >= {8, 4} and {n > 1 for _, n in mma} == {True, False}
    wg = {K._wgmma_plan(*_layer(1, i)[:2], _layer(1, i)[3], _layer(1, i)[4], H100_SMS,
                        dt)[1] for i, r in G1D_CASES if r == "wgmma"
          for dt in (torch.bfloat16, torch.float32)}
    assert 1 in wg and max(wg) > 1


EDGES = [  # (route, B, Cin, T_in, Cout, bias)
    ("wgmma", 3, 24, 2 * 7 + 31, 128, True),   # T_out 8: groups span two batch rows, the
                                               # last half live; tap 31 reads x[T_in]
    ("wgmma", 5, 40, 2 * 23 + 31, 128, False),  # T_out 24: halves across rows, reads x[77]
    ("wgmma", 2, 5, 2 * 16 + 30, 256, True),   # T_out 16, Cin 5: the second stage's
                                               # channels past Cin read as 0
    ("mma", 2, 5, 2 * 15 + 31, 32, True),      # T_out 16, Cin 5; tap 31 reads x[61]
    ("mma", 3, 40, 2 * 47 + 31, 64, False),    # T_out 48: tiles across chunks
]


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("route,B,cin,t_in,cout,bias", EDGES,
                         ids=["T_out=8", "T_out=24", "Cin=5", "mma Cin=5", "mma T_out=48"])
def test_index_maps_match_plain_at_the_edges_of_x(route, B, cin, t_in, cout, bias, fp32):
    """The buffer past T_in holds NaN: the windows must read 0 there."""
    _check(*_inputs(B, cin, t_in, cout, bias=bias, seed=B, fp32=fp32), route)


MUTATIONS = [(r, m) for r in ("wgmma", "mma") for m in ("window +1", "window -1")] + [
    ("wgmma", "half from the wrong row")]  # an mma.sync group never spans two batch rows


@pytest.mark.parametrize("route,mutation", MUTATIONS, ids=[f"{r} {m}" for r, m in MUTATIONS])
def test_a_mutated_kernel_fails(route, mutation):
    """A window one sample off, and a second half's coordinate taken from its group's
    batch row (where the group spans two), break the comparison."""
    B, cin, t_in, cout = (3, 24, 45, 128) if route == "wgmma" else (2, 16, 61, 32)
    emulate = ({"wrong_half": True} if mutation.startswith("half")
               else {"shift": int(mutation[-2:])})
    with pytest.raises(AssertionError):
        _check(*_inputs(B, cin, t_in, cout, seed=7, tail=0.0), route, **emulate)


def test_lanes_take_the_stride_4_taps():
    """A row's taps do not depend on the stride, only its first sample: each lane's A
    loads at stride 2 take, from the row's first sample (2 g in its half's box on wgmma,
    2 r in the group's window on mma.sync), the taps the weights' columns hold there, as
    at stride 4 (bf16 wgmma: the permuted columns, ``WGMMA_TAPS``)."""
    for route in ("wgmma", "mma"):
        for fp32 in (False, True):
            for box, off, cols in _lane_maps(route, fp32):
                taps = np.asarray(WGMMA_TAPS)[cols] if route == "wgmma" and not fp32 else cols
                for r in range(16):
                    start = 2 * (r % 8) if route == "wgmma" else 2 * r
                    assert list(off[r] - start) == list(taps), (route, fp32, r)
                    assert (box[r] == (r // 8 if route == "wgmma" else 0)).all()
    # bf16: a row's first sample 2 g + 8 t + 4 h is odd in 4-byte units for odd g: two
    # 4-byte loads a row (load_a4<2>), not one 8-byte load
    box, off, _ = _lane_maps("wgmma", False)[0]
    assert sorted({int(o) % 4 for o in off[:8, 0:16:2].ravel()}) == [0, 2]
    header = (build.CSRC_DIR / "mma_bf16.cuh").read_text()
    assert "load_a4" in header and "make_uint2(q[0], q[1])" in header


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("bias", [True, False])
def test_emulation_matches_pallas_interpret(bias, fp32):
    """The JAX kernel (interpret mode; stride 2 by space-to-depth) on its own layout: x
    (B, T, C) zero-padded by (15, 15) as Generator1D's blocks pad it, w (K, Cin, Cout);
    128 output channels, T_out 8 at B = 3, so that m16 groups span batch rows and the
    last one is half live; the wgmma route, whose shape it is."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 16, 4).astype(np.float32)
    w = (rng.randn(KW, 4, 128) / np.sqrt(KW * 4)).astype(np.float32)
    b = (rng.randn(128) * 0.1).astype(np.float32)
    a = rng.uniform(0, 0.3, 128).astype(np.float32)
    x_p = np.pad(x, ((0, 0), (15, 15), (0, 0)))
    y_j, pre_j = plconv.fused_conv1d_prelu(
        jnp.asarray(x_p), jnp.asarray(w), jnp.asarray(b if bias else np.zeros_like(b)),
        jnp.asarray(a), S, 256, True)
    # the port's pitched pad of the same x
    x_t = conv_ops.zero_pad_pitched(torch.from_numpy(x.transpose(0, 2, 1)), 15, 15)
    t_in = x_t.shape[-1]
    x_buf = torch.as_strided(x_t, (3, 4, x_t.stride(1)), x_t.stride()).numpy()
    x_buf = x_buf if fp32 else x_buf.astype(np.float64)
    w_t = np.ascontiguousarray(w.transpose(2, 1, 0))
    y, pre = _emulate(x_buf, t_in, w_t if fp32 else w_t.astype(np.float64),
                      b.astype(np.float64) if bias else None, a.astype(np.float64), "wgmma")
    assert pre.shape == (3, 128, 8)
    np.testing.assert_allclose(pre.transpose(0, 2, 1), np.asarray(pre_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.transpose(0, 2, 1), np.asarray(y_j), rtol=1e-5, atol=1e-5)


def test_emulated_constants_are_the_kernels():
    """Change the kernels' windows or stages at stride 2 only together with the
    emulation."""
    def consts(name):
        return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                                 (build.CSRC_DIR / name).read_text())}

    bf16, fp32, mma = (consts(n) for n in ("conv1d_wgmma.cu", "conv1d_wgmma_tf32.cu",
                                           "conv1d_prelu.cu"))
    assert (bf16["WIN_HALF"], bf16["CC"]) == (WIN_HALF, CC["bfloat16"])
    assert (fp32["WIN_HALF"], fp32["CC"]) == (WIN_HALF, CC["float32"])
    assert 2 * WIN_HALF == bf16["WIN"] == fp32["WIN"]  # two halves fill a group's bytes
    assert WIN_HALF >= S * 7 + K.KP and WG_S2 >= S * 15 + K.KP
    assert mma["WG_S2"] == WG_S2
    assert (K.WGMMA_CC, K.WGMMA_TF32_CC) == (CC["bfloat16"], CC["float32"])
    ring = (build.CSRC_DIR / "tma_ring.cuh").read_text()  # both kernels' x windows
    assert "PER_GROUP = S == 4 ? 1 : 2" in ring and "SAMPLES = S == 4 ? WIN : WIN_HALF" in ring
    for name, elem in (("conv1d_wgmma.cu", 2), ("conv1d_wgmma_tf32.cu", 4)):
        src = (build.CSRC_DIR / name).read_text()
        assert f"XBoxes<S, CC, WIN, WIN_HALF, {elem}>" in src and "case 2:" in src
    assert "warp_conv_mma<MMA_MT, S, W>" in (build.CSRC_DIR / "conv1d_prelu.cu").read_text()


# ---- the route rule at stride 2 ------------------------------------------------------

BATCHES = [1, 2, 4, 8, 16, 32, 64, 128, 300]


def _expected_route(dtype, B, i, pitched=True):
    """The rule as ``_route``'s docstring states it at stride 2, for layer i at B chunks:
    FMA below the stride's tensor-core work where mma.sync would take the shape, enc1 by
    its rows, wgmma by its rows or work (and wherever mma.sync cannot take the shape)."""
    _, cin, _, cout, t_out = _layer(B, i)
    rows, work = B * t_out, B * t_out * cout * cin
    min_rows, min_work, enc1_rows, tc_work = K.THRESHOLDS[2]
    mma = t_out % 16 == 0 and cout % 8 == 0
    wgmma = pitched and cin > 1 and cout % 128 == 0 and t_out % 8 == 0
    if cin == 1:
        return "mma" if rows >= enc1_rows[dtype] else "fma"
    if mma and work < tc_work[dtype]:
        return "fma"
    if wgmma and (not mma or rows >= min_rows[dtype] or work >= min_work[dtype]):
        return "wgmma"
    return "mma" if mma else "fma"


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_route_rule_at_every_stride2_shape(dtype, B):
    for i in range(11):
        _, cin, _, cout, t_out = _layer(B, i)
        assert K._route(dtype, B, cin, cout, KW, S, t_out, pitched=True) == (
            _expected_route(dtype, B, i)), (B, i)
        # x in odd rows: never wgmma, and the last layer (T_out 8) on the FMA kernel
        assert K._route(dtype, B, cin, cout, KW, S, t_out, pitched=False) == (
            _expected_route(dtype, B, i, pitched=False)), (B, i)


def test_route_rule_pins_at_stride2():
    """The thresholds, and what they give: Generator1D's encoder at 64 chunks on the
    tensor cores at every layer in both dtypes (mma.sync up to Cout 64, and in bf16 at
    the tenth layer's 1024 rows; wgmma from Cout 128); at 4 chunks (2^23 multiply-adds a
    tap) on the FMA kernel but the last layer, at 8 on the tensor cores; the first layer
    on mma.sync from 32 chunks; the last (T_out 8) on wgmma at every batch."""
    bf16, fp32 = torch.bfloat16, torch.float32
    assert K.THRESHOLDS[2] == ({bf16: 1 << 11, fp32: 1 << 13}, {bf16: 1 << 28, fp32: 1 << 25},
                               {bf16: 1 << 18, fp32: 1 << 18}, {bf16: 1 << 24, fp32: 1 << 24})
    want = {bf16: ["mma"] * 5 + ["wgmma"] * 4 + ["mma", "wgmma"],
            fp32: ["mma"] * 5 + ["wgmma"] * 6}
    for dtype in (bf16, fp32):
        got = [K._route(dtype, 64, *_layer(64, i)[1:2], *_layer(64, i)[3:4], KW, S,
                        _layer(64, i)[4], True) for i in range(11)]
        assert got == want[dtype], (dtype, got)
        assert [_expected_route(dtype, 4, i) for i in range(11)] == ["fma"] * 10 + ["wgmma"]
        assert "fma" not in [_expected_route(dtype, 8, i) for i in range(1, 11)]
        assert [_expected_route(dtype, B, 0) for B in (16, 32)] == ["fma", "mma"]
        for B in BATCHES:
            assert _expected_route(dtype, B, 10) == "wgmma"
    # the stride-4 thresholds are their own (test_torch_conv1d_wgmma's pins)
    assert K.THRESHOLDS[4][:3] == (K.WGMMA_MIN_ROWS, K.WGMMA_MIN_WORK, K.ENC1_MMA_MIN_ROWS)


def test_mma_plan_at_stride2():
    """At stride 2 the 8 x 1 tile for Cin = 1 and for Cout <= 32 in fp32, and split
    counts of powers of two, as the kernel cuts them; stride 4 keeps its plans."""
    bf16, fp32 = torch.bfloat16, torch.float32
    assert K._mma_plan(64, 1, 16, 8192, H100_SMS, 2, bf16)[0] == 8
    assert K._mma_plan(64, 16, 32, 4096, H100_SMS, 2, fp32)[0] == 8
    assert K._mma_plan(64, 16, 32, 4096, H100_SMS, 2, bf16)[0] == 4
    assert K._mma_plan(64, 32, 64, 1024, H100_SMS, 2, fp32)[0] == 4
    for dt in (bf16, fp32):
        assert K._mma_plan(64, 16, 32, 4096, H100_SMS, 4, dt)[0] == 4
    for B in BATCHES:
        for i in range(10):
            _, cin, _, cout, t_out = _layer(B, i)
            for dt in (bf16, fp32):
                warps_m, n = K._mma_plan(B, cin, cout, t_out, H100_SMS, 2, dt)
                # the slices of the tile's own count, rounded down to a power of two
                p2 = 1 << (K._mma_splits(B, cin, cout, t_out, H100_SMS, warps_m)
                           .bit_length() - 1)
                assert n == -(-cin // -(-cin // p2)), (B, i, dt)
    # the stride-4 plan of Generator1D's fifth layer at 64 chunks cuts 3 slices, stride 2 2
    assert K._mma_plan(64, 64, 64, 512, H100_SMS)[1] == 3
    assert K._mma_plan(64, 64, 64, 512, H100_SMS, 2, bf16)[1] == 2


def test_launch_passes_the_stride(fake_lib):
    """Without a card: stride-2 calls reach each tensor-core entry with the stride as the
    argument before the stream, the pitch and T_in as at stride 4; a layer of T_out 8
    takes wgmma, and forcing mma.sync on it raises before anything launches."""
    g = torch.Generator().manual_seed(0)
    for i, want in ((8, "wgmma"), (3, "mma"), (10, "wgmma")):
        B, cin, t_in, cout, t_out = _layer(64, i)
        h = torch.randn((B, cin, t_in - 30), generator=g).bfloat16()
        x = conv_ops.zero_pad_pitched(h, 15, 15)
        w = torch.randn((cout, cin, KW), generator=g).bfloat16()
        a = torch.rand((cout,), generator=g).bfloat16()
        K._launch(x, w, None, a, S, t_out)
        name, args = fake_lib.calls[-1]
        assert name == want and args[-2] == S, (i, name)
        assert args[9:14] == (B, cin, t_in, x.stride(1), cout)
    n = len(fake_lib.calls)
    with pytest.raises(ValueError, match="route"):
        K._launch(x, w, None, a, S, t_out, force="mma")
    assert len(fake_lib.calls) == n


# ---- Generator1D's pitched pad ------------------------------------------------------


@pytest.mark.parametrize("T_x", [16384, 1024, 16, 8, 5, 1])
@pytest.mark.parametrize("pads", [(15, 15), (14, 15), (0, 0)], ids=["g1d", "g", "none"])
def test_zero_pitched_pad_equals_zero_pad(T_x, pads):
    x = torch.randn(2, 3, T_x)
    got = conv_ops.zero_pad_pitched(x, *pads)
    assert torch.equal(got, conv_ops.zero_pad_1d(x, *pads))
    pitch = got.stride(1)
    assert got.stride() == (3 * pitch, pitch, 1) and pitch % 8 == 0
    assert pitch - got.shape[-1] < 8 and got.storage_offset() == 0


def test_zero_pitched_pad_gradient_equals_zero_pad_gradient():
    x = torch.randn(2, 3, 40, dtype=torch.float64, requires_grad=True)
    gy = torch.randn(2, 3, 70, dtype=torch.float64)
    (g1,) = torch.autograd.grad((conv_ops.zero_pad_pitched(x, 15, 15) * gy).sum(), x)
    (g2,) = torch.autograd.grad((conv_ops.zero_pad_1d(x, 15, 15) * gy).sum(), x)
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("pad_type", ["constant", "reflect"])
def test_generator1d_blocks_pass_pitched_views(monkeypatch, pad_type):
    """Generator1D's fused encoder blocks hand the op x in rows whose pitch is a multiple
    of 8 (T_in = 2 T_out + 30, never one); the plain version and the backward take the
    view, and the forward and gradients equal those on contiguous pads."""
    seen = []
    real = tg1d.conv1d_prelu

    def spy(x, w, b, a, stride):
        seen.append((x.shape, x.stride()))
        return real(x, w, b, a, stride)

    G = tg1d.Generator1D(1, [8, 16, 32], 31, pooling=2, z_dim=16, pad_type=pad_type,
                         generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 1024, 1)
    z = torch.randn(2, 1024 // 8, 16)
    monkeypatch.setattr(tg1d, "conv1d_prelu", spy)
    out = G(x, z)
    out.sum().backward()
    grads = [p.grad.clone() for p in G.parameters()]
    assert len(seen) == 3  # the three encoder blocks
    for (B, cin, t_in), stride in seen:
        assert t_in % 8 != 0 and stride[1] % 8 == 0
        assert stride == (cin * stride[1], stride[1], 1)
    monkeypatch.setattr(conv_ops, "zero_pad_pitched", conv_ops.zero_pad_1d)
    monkeypatch.setattr(conv_ops, "reflect_pad_pitched", conv_ops.reflect_pad_1d)
    G.zero_grad()
    ref = G(x, z)
    ref.sum().backward()
    assert torch.equal(out, ref)
    assert all(torch.equal(g, p.grad) for g, p in zip(grads, G.parameters()))
