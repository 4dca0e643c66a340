"""The fp32 wgmma route of the port's fused conv + bias + PReLU
(segan_pytorch_tpu_torch/csrc/conv1d_wgmma_tf32.cu, ``conv1d_wgmma_tf32_kernel``): its
index maps, the TF32 split, the fold of the fresh partial sums, its weights and the
route rule that sends fp32 calls to it.

No card here: a float64 numpy emulation of exactly the kernel's index maps (x read through
its pitched rows by TMA boxes of 96 samples x 2 channels per m16 group, zero at or past
T_in and past Cin; the weights padded to 32 taps and split into their TF32 parts by the
wrapper, as the mma.sync route takes them, read in their order, 32 bytes an 8-deep step;
each lane's A fragments loaded from the staged window and split with ``cvt.rna``; each
channel's three products per step summed from zero
and folded into the running sums; ring stages of 2 channels, split-K slices of whole
stages summed in the epilogue's order; each warp's m16 group stored) is held against the
plain version at full SEGAN+ width and against the JAX Pallas kernel in interpret mode.
Products of TF32 parts are exact in float64, so what the emulation differs by from the
exact conv is the split alone; the rounding of the kernel's fp32 sums is the card's to
show (chip_smoke.py holds enc5 at 300 chunks against float64).
"""
import gc
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from segan_pytorch_tpu.ops.conv import reflect_pad_1d as jax_reflect_pad_1d
from segan_pytorch_tpu.ops.pallas import conv1d as plconv
from segan_pytorch_tpu_torch.ops import conv as conv_ops
from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from test_torch_conv1d_tf32 import SPLIT_ERR, _tf32_taps, split
from test_torch_conv1d_wgmma import (BATCHES, CHANS, H100_SMS, KW, T, _cheapest_plan,
                                     _expected_route, _main_path, fake_lib)  # noqa: F401

# conv1d_wgmma_tf32_kernel's constants, as in csrc/conv1d_wgmma_tf32.cu
BN, CC, WIN, STAGES, STEPS, CONSUMERS = 128, 2, 96, 3, 4, 2


def _taps():
    """taps[s, c]: the tap that 8-deep step s of a channel takes at contraction index c,
    8 s + c: the padded taps in their order, column 8 s + c of the wrapper's weights."""
    return np.arange(STEPS * 8).reshape(STEPS, 8)


def _a_index():
    """a_idx[s, r, c]: the window sample (from 4 t0) that row r of an m16 group takes at
    contraction index c of step s, built lane by lane as the kernel loads it: lane (g, t)
    loads samples 4 g + 8 s + t and 4 g + 8 s + t + 4 for row g and 32 on for row g + 8,
    in the registers of the wgmma k8 A fragment {(g, t), (g + 8, t), (g, t + 4),
    (g + 8, t + 4)}."""
    a_idx = np.full((STEPS, 16, 8), -1)
    for s in range(STEPS):
        for g in range(8):
            for t in range(4):
                p = 4 * g + 8 * s + t
                a_idx[s, g, t], a_idx[s, g + 8, t] = p, p + 4 * 8
                a_idx[s, g, t + 4], a_idx[s, g + 8, t + 4] = p + 4, p + 4 * 8 + 4
    assert (a_idx >= 0).all() and a_idx.max() < WIN
    return a_idx


def _emulate_wgmma_tf32_kernel(x_buf, t_in, w, b, a, num_sms=H100_SMS, shift=0,
                               w_parts=None, swap_x=False):
    """What conv1d_wgmma_tf32_kernel computes, in float64 numpy: (y, pre) (B, Cout,
    T_out), NaN where no warp stores. x_buf is x's float32 pitched buffer (B, Cin,
    pitch), of which TMA reads samples < t_in; w float32 (Cout, Cin, K). `shift` moves
    every window by that many samples, `w_parts` replaces the wrapper's (big, small)
    weights and `swap_x` swaps x's two parts (mutations the comparisons must catch)."""
    B, cin, pitch = x_buf.shape
    cout, _, k = w.shape
    t_out = (t_in - k) // 4 + 1
    assert x_buf.dtype == np.float32 and w.dtype == np.float32
    assert pitch % 8 == 0 and pitch >= t_in and cout % BN == 0
    assert K._tensor_core_shape(torch.float32, cout, k, 4, t_out)
    if w_parts is None:
        w_parts = [v.numpy() for v in K._mma_weights(torch.from_numpy(w))]
    w_big, w_small = (v.astype(np.float64) for v in w_parts)  # (Cout, Cin, 32) each
    m_tiles, splits = K._wgmma_plan(B, cin, cout, t_out, num_sms, torch.float32)
    assert m_tiles == 1
    per = -(-(-(-cin // splits)) // CC) * CC  # channels per slice: whole stages
    assert -(-cin // per) == splits
    M = B * t_out
    groups = M // 16
    gb, gt0 = np.divmod(np.arange(groups) * 16, t_out)  # group q: batch row, first step
    # a channel's A over its four steps, column 8 s + c as in the weights (the steps' sums
    # add in float64, where their order does not show)
    a_all = _a_index().transpose(1, 0, 2).reshape(16, STEPS * 8)
    # the TMA box of group q: samples 4 t0 + j of x, 0 at or past t_in (the map's bound)
    samp = 4 * gt0[:, None] + shift + np.arange(WIN)[None, :]
    inside = (samp >= 0) & (samp < t_in)
    samp = np.clip(samp, 0, t_in - 1)
    partial = np.zeros((splits, groups, 16, cout))
    for z in range(splits):
        for c0 in range(z * per, min(cin, (z + 1) * per), CC):  # ring stages
            ch = c0 + np.arange(CC)
            live = ch < cin  # channels past Cin: TMA's zeros, in x and in w
            chc = np.minimum(ch, cin - 1)
            win = np.where(inside[:, None, :] & live[None, :, None],
                           x_buf[gb[:, None, None], chc[None, :, None], samp[:, None, :]],
                           np.float32(0))  # (group, channel, sample)
            x_big, x_small = (v.astype(np.float64) for v in split(win))
            if swap_x:
                x_big, x_small = x_small, x_big
            wb, ws = (np.where(live[None, :, None], v[:, chc], 0.0) for v in (w_big, w_small))
            for c in range(CC):  # each channel: fresh sums, then the fold
                xb, xs = x_big[:, c][:, a_all], x_small[:, c][:, a_all]
                # the kernel's three MMAs: small x big, big x small, big x big
                part = xs @ wb[:, c].T
                part += xb @ ws[:, c].T
                part += xb @ wb[:, c].T
                partial[z] += part
    acc = partial[0]
    for z in range(1, splits):  # the split-K epilogue's order
        acc = acc + partial[z]
    acc = acc.reshape(M, cout)
    pre_rows = acc + (0.0 if b is None else b)
    y_rows = np.maximum(pre_rows, 0) + a * np.minimum(pre_rows, 0)
    y, pre = np.full((B, cout, t_out), np.nan), np.full((B, cout, t_out), np.nan)
    gpb = CONSUMERS * 4  # m16 groups per block: one m64 tile per consumer
    for bx in range(-(-groups // gpb)):
        for wg in range(CONSUMERS):
            for warp in range(4):
                q = bx * gpb + wg * 4 + warp
                if q >= groups:
                    continue
                rows = slice(16 * q, 16 * q + 16)
                steps = slice(gt0[q], gt0[q] + 16)
                for n0 in range(0, cout, BN):  # every block column
                    chs = slice(n0, n0 + BN)
                    pre[gb[q], chs, steps] = pre_rows[rows, chs].T
                    y[gb[q], chs, steps] = y_rows[rows, chs].T
    return y, pre


def _pitched_inputs(B, cin, t_in, cout, bias=False, seed=0, tail=np.nan):
    """float32 x's pitched buffer (B, Cin, pitch) with `tail` past T_in (NaN: a kernel
    that read it would fail), w at 1/sqrt(K Cin); float64 bias and slopes U(0, 0.3)."""
    rng = np.random.RandomState(seed)
    pitch = -(-t_in // 8) * 8
    x_buf = np.full((B, cin, pitch), tail, np.float32)
    x_buf[..., :t_in] = rng.randn(B, cin, t_in)
    w = (rng.randn(cout, cin, KW) / np.sqrt(KW * cin)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32).astype(np.float64) if bias else None
    a = rng.uniform(0, 0.3, cout).astype(np.float32).astype(np.float64)
    return x_buf, t_in, w, b, a


def _check_against_plain(x_buf, t_in, w, b, a, **emulate):
    """The emulation vs the exact conv (the plain version in float64 on the same float32
    values): every output within the split's bound, SPLIT_ERR times sum |x| |w| over its
    window, and the port's fp32 limit of 1e-4 relative met with a margin of 100."""
    y, pre = _emulate_wgmma_tf32_kernel(x_buf, t_in, w, b, a, **emulate)
    t = lambda v: None if v is None else torch.from_numpy(v).double()
    x = x_buf[..., :t_in]
    y_ref, pre_ref = (v.numpy() for v in K.conv1d_prelu_plain(t(x), t(w), t(b), t(a), 4))
    bound = SPLIT_ERR * K.conv1d(t(np.abs(x)), t(np.abs(w)), None, 4).numpy() + 1e-12
    assert not np.isnan(pre).any() and not np.isnan(y).any(), "rows no warp stores"
    assert (np.abs(pre - pre_ref) <= bound).all(), np.max(np.abs(pre - pre_ref) / bound)
    assert (np.abs(y - y_ref) <= bound).all(), np.max(np.abs(y - y_ref) / bound)
    for got, ref in ((y, y_ref), (pre, pre_ref)):
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


FULL_WIDTH = [(1, 1, H100_SMS), (2, 2, H100_SMS), (4, 3, H100_SMS), (8, 4, H100_SMS),
              (4, 1, 16)]


@pytest.mark.parametrize("B,layer,num_sms", FULL_WIDTH,
                         ids=["enc2 B=1", "enc3 B=2", "enc4 B=4", "enc5 B=8 one block",
                              "enc2 B=4 16 SMs"])
def test_index_maps_match_plain_full_width(B, layer, num_sms):
    _, cin, t_in, cout, _ = _main_path(B, layer)
    _check_against_plain(*_pitched_inputs(B, cin, t_in, cout, seed=layer),
                         num_sms=num_sms)


def test_full_width_cases_cover_both_epilogues():
    """The parametrised cases above reach split-K and the stores through shared memory."""
    splits = {K._wgmma_plan(B, CHANS[l], CHANS[l + 1], T // 4 ** (l + 1), n,
                            torch.float32)[1] for B, l, n in FULL_WIDTH}
    assert 1 in splits and max(splits) > 1


@pytest.mark.parametrize("B,cin,t_in,cout,bias", [
    (3, 24, 91, 128, True),            # T_out 16: the zero tap of the last row reads x[91]
    (2, 5, 4 * 63 + 31, 256, True),    # Cin 5: the third stage reads channel 5 as 0
    (5, 40, 4 * 47 + 31, 128, False),  # T_out 48: blocks across chunks, a partial one
], ids=["T_in=91", "Cin=5", "T_out=48"])
def test_index_maps_match_plain_at_the_edges_of_x(B, cin, t_in, cout, bias):
    """The buffer past T_in holds NaN: the kernel's windows must read 0 there."""
    assert (t_in - KW) % 4 == 0
    _check_against_plain(*_pitched_inputs(B, cin, t_in, cout, bias=bias, seed=B))


@pytest.mark.parametrize("mutation", ["window +1", "window -1",
                                      "taps in the mma.sync fragments' order",
                                      "taps in the bf16 wgmma order", "steps swapped",
                                      "w parts swapped", "x parts swapped"])
def test_a_mutated_kernel_fails(mutation):
    """A one-sample window shift, a wrong tap permutation and a swapped big / small part
    each break the split's bound."""
    x_buf, t_in, w, b, a = _pitched_inputs(*_main_path(1, 1)[:4], seed=12, tail=0.0)
    padded = K._pad_taps(torch.from_numpy(w))
    parts = np.stack(split(padded.numpy()))
    emulate = {}
    if mutation.startswith("window"):
        emulate["shift"] = int(mutation[-2:])
    elif mutation == "taps in the mma.sync fragments' order":
        emulate["w_parts"] = parts[..., _tf32_taps().ravel()]
    elif mutation == "taps in the bf16 wgmma order":
        emulate["w_parts"] = np.stack(split(K._wgmma_weights(padded.double()).float().numpy()))
    elif mutation == "steps swapped":
        emulate["w_parts"] = np.concatenate([parts[..., 8:16], parts[..., :8],
                                             parts[..., 16:]], axis=-1)
    elif mutation == "w parts swapped":
        emulate["w_parts"] = parts[::-1]
    else:
        emulate["swap_x"] = True
    with pytest.raises(AssertionError):
        _check_against_plain(x_buf, t_in, w, b, a, **emulate)


def test_lanes_load_the_taps_in_their_order():
    """Each lane's A loads take the padded taps in their order, 8 a step, so the kernel
    reads the weights of the mma.sync route as they are: their TF32 parts, bit for bit
    (test_torch_conv1d_tf32's `split`), tap 31 zero in both."""
    taps = _taps()
    a_idx = _a_index()
    for s in range(STEPS):
        for r in range(16):
            assert list(a_idx[s, r] - 4 * r) == list(taps[s])
    w = (np.random.RandomState(4).randn(3, 2, 31) * 0.1).astype(np.float32)
    parts = K._padded_weights(torch.from_numpy(w))
    assert [v.shape for v in parts] == [(3, 2, 32)] * 2
    want = split(K._pad_taps(torch.from_numpy(w)).numpy())
    for got, ref in zip(parts, want):
        assert got.is_contiguous() and not got[..., 31].any()
        assert got.numpy().view(np.uint32).tolist() == ref.view(np.uint32).tolist()


@pytest.mark.parametrize("bias", [True, False])
def test_emulation_matches_pallas_interpret(bias):
    """The JAX kernel (interpret mode, fp32) on its own layout: x (B, T, C) reflect-padded
    as its block pads it, w (K, Cin, Cout); 128 output channels, T_out 64. Both sides are
    within ~1e-6 of the exact conv: 1e-5 relative."""
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
    x_t = conv_ops.reflect_pad_pitched(torch.from_numpy(x.transpose(0, 2, 1)), KW // 2 - 1,
                                       KW // 2)
    t_in = x_t.shape[-1]
    x_buf = torch.as_strided(x_t, (2, 4, x_t.stride(1)), x_t.stride()).numpy()
    y, pre = _emulate_wgmma_tf32_kernel(x_buf, t_in, np.ascontiguousarray(w.transpose(2, 1, 0)),
                                        b.astype(np.float64) if bias else None,
                                        a.astype(np.float64))
    assert pre.shape == (2, 128, 64)
    np.testing.assert_allclose(pre.transpose(0, 2, 1), np.asarray(pre_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.transpose(0, 2, 1), np.asarray(y_j), rtol=1e-5, atol=1e-5)


def test_emulated_constants_are_the_kernels():
    """Change the kernel's ring, tiles, windows or steps only together with its emulation;
    both wgmma kernels take their ring from one header."""
    src = (build.CSRC_DIR / "conv1d_wgmma_tf32.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert [int(consts[n]) for n in ("BN", "CC", "WIN", "STAGES", "STEPS", "CONSUMERS")] == [
        BN, CC, WIN, STAGES, STEPS, CONSUMERS]
    assert (K.WGMMA_BN, K.WGMMA_TF32_CC, K.WGMMA_TILES[torch.float32]) == (BN, CC, (1,))
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in src
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in src and "__grid_constant__" in src
    assert "split_tf32" in src and '#include "mma_tf32.cuh"' in src
    assert src.count("encode_w_map(") == 2  # the two parts, one map each
    ring = (build.CSRC_DIR / "tma_ring.cuh").read_text()
    assert "mbarrier.try_wait" in ring and "cp.async.bulk.tensor.3d" in ring
    for name in ("conv1d_wgmma.cu", "conv1d_wgmma_tf32.cu"):
        text = (build.CSRC_DIR / name).read_text()
        assert '#include "tma_ring.cuh"' in text
        # one copy of the ring's helpers: none defined again in a kernel's source
        assert "mbarrier.try_wait" not in text and "cuTensorMapEncodeTiled\", &p" not in text


def test_library_builds_from_its_own_source(monkeypatch, tmp_path):
    """csrc/conv1d_wgmma_tf32.cu is a library of its own, and the ring's header is hashed
    into both wgmma libraries' names."""
    for f in build.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    names = ("conv1d_wgmma", "conv1d_wgmma_tf32")
    before = {n: build.library_path(n) for n in names}
    assert before["conv1d_wgmma"] != before["conv1d_wgmma_tf32"]
    (tmp_path / "tma_ring.cuh").write_text("// edited\n")
    assert all(build.library_path(n) != p for n, p in before.items())
    cmd = build.nvcc_command("nvcc", "conv1d_wgmma_tf32", tmp_path / "x.so")
    assert cmd[-1].endswith("conv1d_wgmma_tf32.cu") and "arch=compute_90a,code=sm_90a" in cmd


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("layer", range(5), ids=[f"enc{i + 1}" for i in range(5)])
def test_fp32_route_and_plan_at_every_main_path_shape(B, layer):
    """G's pitched rows take the rule's route; contiguous odd rows (T_in = 4 T_out + 29)
    take mma.sync wherever the rule gives wgmma; enc1 (Cin = 1) never takes wgmma; the
    plan is the cheapest under the stated model."""
    _, cin, t_in, cout, t_out = _main_path(B, layer)
    assert t_in % 2 == 1
    fp32 = torch.float32
    want = _expected_route(fp32, B, layer)
    assert K._route(fp32, B, cin, cout, KW, 4, t_out, pitched=True) == want
    assert K._route(fp32, B, cin, cout, KW, 4, t_out, pitched=False) == (
        _expected_route(fp32, B, layer, pitched=False))
    if layer == 0:
        assert want != "wgmma"
    if want == "wgmma":
        assert K._route(fp32, B, cin, cout, KW, 4, t_out, pitched=False) == "mma"
        assert K._wgmma_plan(B, cin, cout, t_out, H100_SMS, fp32) == (
            _cheapest_plan(B, cin, cout, t_out, dtype=fp32))


def _fp32_layer(B, layer, pitched=True, seed=0):
    _, cin, t_in, cout, t_out = _main_path(B, layer)
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((B, cin, t_in - 29), generator=g)
    x = (conv_ops.reflect_pad_pitched if pitched else conv_ops.reflect_pad_1d)(h, 14, 15)
    w = torch.randn((cout, cin, KW), generator=g)
    a = torch.rand((cout,), generator=g)
    return x, w, a, t_out


def test_launch_dispatches_the_fp32_wgmma_route(fake_lib):
    """Without a card: a pitched fp32 main-path call reaches the fp32 wgmma entry with the
    (big, small) pair of the mma.sync route (one copy for both: none in the permuted
    cache), its plan and the pitch, and moves all four counters; force="mma" takes the
    3xTF32 mma.sync entry with the same pair, which counts in launches_tf32 too;
    contiguous odd rows take mma.sync and refuse wgmma."""
    x, w, a, t_out = _fp32_layer(64, 2)
    assert K._route(torch.float32, 64, 128, 256, KW, 4, t_out, pitched=True) == "wgmma"
    counters = lambda: (K.launches, K.launches_mma, K.launches_tf32, K.launches_wgmma)
    before = counters()
    K._launch(x, w, None, a, 4, t_out)
    name, args = fake_lib.calls[-1]
    assert name == "wgmma_tf32" and w not in K._permuted
    pair = tuple(v.data_ptr() for v in K._padded_weights(w))
    assert args[0] == x.data_ptr() and args[1:3] == pair
    assert args[8:10] == K._wgmma_plan(64, 128, 256, t_out, H100_SMS, torch.float32)
    assert args[10:15] == (64, 128, x.shape[2], x.stride(1), 256)
    assert counters() == tuple(n + 1 for n in before)
    K._launch(x, w, None, a, 4, t_out, force="mma")
    name, args = fake_lib.calls[-1]
    assert name == "tf32" and args[1:3] == pair
    assert counters() == (before[0] + 2, before[1] + 2, before[2] + 2, before[3] + 1)
    xc, _, _, _ = _fp32_layer(64, 2, pitched=False)
    K._launch(xc, w, None, a, 4, t_out)
    assert fake_lib.calls[-1][0] == "tf32"
    n = (K.launches, len(fake_lib.calls))
    with pytest.raises(ValueError, match="wgmma"):
        K._launch(xc, w, None, a, 4, t_out, force="wgmma")
    assert (K.launches, len(fake_lib.calls)) == n


def test_fp32_wgmma_needs_aligned_outputs(fake_lib):
    """The kernel stores 16 bytes a lane: outputs off 16 bytes raise before launch."""
    x, w, a, t_out = _fp32_layer(64, 2)
    shape = (64, 256, t_out)
    buf = torch.empty(2 * 64 * 256 * t_out + 1)
    out = (buf[1:1 + 64 * 256 * t_out].view(shape), torch.empty(shape))
    n = (K.launches, len(fake_lib.calls))
    with pytest.raises(ValueError, match="16-byte"):
        K._launch(x, w, None, a, 4, t_out, out=out)
    assert (K.launches, len(fake_lib.calls)) == n


def test_fp32_split_weights_follow_the_weight_and_version(monkeypatch):
    """The split pair both fp32 routes take: made once per weight and version; rebuilt
    after an optimizer step in place; under CUDA graph capture neither read nor written (a
    stale entry would feed every replay the weights of capture time)."""
    same = lambda got, w: all(torch.equal(g, r) for g, r in zip(got, K._mma_weights(w)))
    w = torch.nn.Parameter(torch.randn(128, 8, 31))
    wp = K._padded_weights(w)
    assert same(wp, w) and K._padded_weights(w) is wp
    w.grad = torch.randn_like(w)
    torch.optim.SGD([w], lr=0.1).step()
    wp2 = K._padded_weights(w)
    assert wp2 is not wp and same(wp2, w)
    monkeypatch.setattr(K, "_capturing", lambda: True)
    entry, n = K._padded[w], len(K._padded)
    with torch.no_grad():
        w.mul_(2)
    during = K._padded_weights(w)
    assert same(during, w) and during is not wp2
    assert K._padded[w] is entry and len(K._padded) == n  # the cache untouched
    monkeypatch.setattr(K, "_capturing", lambda: False)
    after = K._padded_weights(w)
    assert after is not wp2 and same(after, w)
    n = len(K._padded)
    del w, wp, wp2, during, after, entry
    gc.collect()
    assert len(K._padded) == n - 1
