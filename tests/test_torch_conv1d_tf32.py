"""The fp32 tensor-core route of the port's fused conv + bias + PReLU
(segan_pytorch_tpu_torch/csrc/conv1d_prelu.cu, ``conv1d_tf32_kernel``, mainloop
``warp_conv_3xtf32`` in csrc/mma_tf32.cuh): the TF32 split, its error bound, the kernel's
index maps and the route rule.

No card here: a numpy helper rounds to TF32 as ``cvt.rna.tf32.f32`` does, and a float64
emulation of exactly the kernel's index maps (per m16 group windows staged 64 at a time,
samples past T_in staged as 0, the 32 padded taps in the order the m16n8k8 fragments
take them, each operand split into its two TF32 parts and each product taken as the
kernel's three, split-K slices cut on channels and summed in the epilogue's order, the
warps' tiles) is held against the plain version at full SEGAN+ width and against the JAX
Pallas kernel in interpret mode. On the card chip_smoke.py holds the kernel itself
against the plain version and, at enc5, against float64.
"""
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from segan_pytorch_tpu.ops.conv import reflect_pad_1d
from segan_pytorch_tpu.ops.pallas import conv1d as plconv
from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from segan_pytorch_tpu_torch.tools import conv1d_mma_ab as ab

# conv1d_tf32_kernel's constants, as in csrc/conv1d_prelu.cu
WG, STAGED_TF32, MMA_MT = 96, 64, 4
H100_SMS = 132
T, KW = 16384, 31
CHANS = [1, 64, 128, 256, 512, 1024]
# a product's error in 3xTF32, relative to |a| |b| (test_split_error_bound_on_random_data)
SPLIT_ERR = 3.01 * 2.0 ** -22


def _main_path(B, layer):
    """(B, Cin, T_in, Cout) of encoder layer `layer` (0-4) for B 16384-sample chunks."""
    t_out = T // 4 ** (layer + 1)
    return B, CHANS[layer], 4 * t_out + KW - 2, CHANS[layer + 1]  # G pads by 29


def tf32_rna(v):
    """float32 v rounded to TF32 as cvt.rna.tf32.f32: half an ulp of the 10-bit mantissa
    (0x1000) added to the bit pattern, the 13 low bits cleared (ties away from zero, a
    carry into the exponent); NaN kept."""
    v = np.asarray(v, np.float32)
    bits = (v.view(np.uint32).astype(np.uint64) + 0x1000) & 0xFFFFE000
    return np.where(np.isnan(v), v, bits.astype(np.uint32).view(np.float32))


def split(v):
    """(big, small) TF32 parts of float32 v, as the kernel and the wrapper make them."""
    v = np.asarray(v, np.float32)
    big = tf32_rna(v)
    return big, tf32_rna(v - big)  # v - big is exact in float32


def _tf32_taps():
    """taps[s, k]: the tap that 8-deep step s of an input channel takes at contraction
    index k (lane quad q holds k = q and q + 4: taps 8q + 2s and 8q + 2s + 1)."""
    taps = np.empty((4, 8), np.int64)
    for s in range(4):
        for q in range(4):
            taps[s, [q, q + 4]] = 8 * q + 2 * s + np.arange(2)
    return taps


def _emulate_tf32_kernel(x, w, b, a, num_sms=H100_SMS, shift=0):
    """What conv1d_tf32_kernel computes, in float64 numpy (port layout), from float32
    inputs: (y, pre), NaN where no warp writes. Products of TF32 parts are exact in
    float64, so what differs from the exact conv is the split alone; the rounding of the
    kernel's fp32 sums (partial sums of half a channel, then fp32 adds) is the card's to
    show. `shift` moves every staged window by that many samples (a mutation the
    comparisons must catch)."""
    B, cin, t_in = x.shape
    cout, _, k = w.shape
    t_out = (t_in - k) // 4 + 1
    assert K._tensor_core_shape(torch.float32, cout, k, 4, t_out)
    w_big, w_small = (v.astype(np.float64) for v in split(
        K._pad_taps(torch.from_numpy(np.asarray(w, np.float32))).numpy()))
    warps_m, splits = K._mma_plan(B, cin, cout, t_out, num_sms)
    nq, tile_n = MMA_MT * warps_m, 256 // warps_m
    cc_max = STAGED_TF32 // nq
    per = -(-cin // splits)
    assert -(-cin // per) == splits  # the kernel's slices: none empty
    M = B * t_out
    groups = M // 16
    gb, gt0 = np.divmod(np.arange(groups) * 16, t_out)  # group q: batch row, first step
    taps, r = _tf32_taps(), np.arange(16)
    # the staged window of each group: sample 4 t0 + j of x, 0 at or past T_in
    idx = 4 * gt0[:, None] + shift + np.arange(WG)[None, :]
    inside = (idx >= 0) & (idx < t_in)
    idx = np.clip(idx, 0, t_in - 1)
    partial = np.zeros((splits, groups * 16, cout))
    for z in range(splits):
        c_end = min(cin, (z + 1) * per)
        for c0 in range(z * per, c_end, cc_max):
            ch = np.arange(c0, min(c0 + cc_max, c_end))
            xs = np.where(inside[:, None, :],
                          x[gb[:, None, None], ch[None, :, None], idx[:, None, :]], 0.0)
            x_big, x_small = (v.astype(np.float64) for v in split(xs))
            for s in range(4):
                def rows(v):  # (group * 16 + row, ch * 8 + k)
                    A = v[:, :, 4 * r[:, None] + taps[s][None, :]]  # (group, ch, row, k)
                    return A.transpose(0, 2, 1, 3).reshape(groups * 16, -1)

                def cols(v):  # (ch * 8 + k, cout)
                    return v[:, ch][:, :, taps[s]].reshape(cout, -1).T

                # the kernel's three MMAs: small x big, big x small, big x big
                partial[z] += rows(x_small) @ cols(w_big)
                partial[z] += rows(x_big) @ cols(w_small)
                partial[z] += rows(x_big) @ cols(w_big)
    acc = partial[0]
    for z in range(1, splits):  # the split-K epilogue's order
        acc = acc + partial[z]
    pre_rows = acc + (0.0 if b is None else b)
    y_rows = np.maximum(pre_rows, 0) + a * np.minimum(pre_rows, 0)
    y, pre = np.full((B, cout, t_out), np.nan), np.full((B, cout, t_out), np.nan)
    for bx in range(-(-M // (16 * nq))):
        for wm in range(warps_m):
            mt_live = min(MMA_MT, max(0, (M - 16 * nq * bx) // 16 - wm * MMA_MT))
            for i in range(mt_live):
                q = nq * bx + MMA_MT * wm + i
                rows_q = slice(16 * q, 16 * q + 16)
                for n0 in range(0, -(-cout // tile_n) * tile_n, 32):  # every warp's n0
                    nt_live = min(4, max(0, (cout - n0) // 8))
                    chs = slice(n0, n0 + 8 * nt_live)
                    steps = slice(gt0[q], gt0[q] + 16)
                    pre[gb[q], chs, steps] = pre_rows[rows_q, chs].T
                    y[gb[q], chs, steps] = y_rows[rows_q, chs].T
    return y, pre


def _inputs(B, cin, t_in, cout, k=KW, bias=False, seed=0):
    """float32 port-layout inputs: x (B, Cin, T_in) already padded, w at 1/sqrt(K Cin),
    slopes U(0, 0.3) so that the negative branch counts."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, cin, t_in).astype(np.float32)
    w = (rng.randn(cout, cin, k) / np.sqrt(k * cin)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32) if bias else None
    a = rng.uniform(0, 0.3, cout).astype(np.float32)
    return x, w, b, a


def _check_against_plain(x, w, b, a, **emulate):
    """The emulation vs the exact conv (the plain version in float64 on the same float32
    values): every output within the split's bound, SPLIT_ERR times sum |x| |w| over its
    window (times the slope on the negative side, within 1), and the port's fp32 limit
    of 1e-4 relative met with a margin of 100."""
    y, pre = _emulate_tf32_kernel(x, w, b, a, **emulate)
    t = lambda v: None if v is None else torch.from_numpy(v).double()
    y_ref, pre_ref = (v.numpy() for v in K.conv1d_prelu_plain(t(x), t(w), t(b), t(a), 4))
    mag = K.conv1d(t(np.abs(x)), t(np.abs(w)), None, 4).numpy()
    bound = SPLIT_ERR * mag + 1e-12
    assert not np.isnan(pre).any() and not np.isnan(y).any(), "rows no warp writes"
    assert (np.abs(pre - pre_ref) <= bound).all(), np.max(np.abs(pre - pre_ref) / bound)
    assert (np.abs(y - y_ref) <= bound).all(), np.max(np.abs(y - y_ref) / bound)
    for got, ref in ((y, y_ref), (pre, pre_ref)):
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_tf32_rna_on_hand_picked_values():
    """Ties go away from zero, in both signs; one bit below a tie goes down; the carry
    reaches the exponent, and the largest finite float32 values round to infinity."""
    u = lambda bits: np.array([bits], np.uint32).view(np.float32)[0]
    one = np.float32(1.0)
    cases = [
        (one, one),
        (u(0x3F801000), u(0x3F802000)),   # 1 + 2^-11, a tie: up to 1 + 2^-10
        (u(0xBF801000), u(0xBF802000)),   # its negative: away from zero
        (u(0x3F800FFF), one),             # just below the tie
        (u(0x3F801001), u(0x3F802000)),   # just above it
        (u(0x3F803000), u(0x3F804000)),   # a tie on an odd last bit: still away
        (u(0x3FFFF000), np.float32(2.0)),  # the carry into the exponent
        (u(0x7F7FEFFF), u(0x7F7FE000)),   # the largest value that stays finite
        (u(0x7F7FF000), np.float32(np.inf)),   # a tie at the top: infinity
        (u(0x7F7FFFFF), np.float32(np.inf)),   # float32's largest finite value
        (u(0xFF7FFFFF), np.float32(-np.inf)),
        (np.float32(np.inf), np.float32(np.inf)),
        (np.float32(0.0), np.float32(0.0)),
        (u(0x00001000), u(0x00002000)),   # a subnormal tie
    ]
    got = tf32_rna([c for c, _ in cases])
    want = np.array([w for _, w in cases], np.float32)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    assert np.signbit(tf32_rna([-0.0]))[0] and np.isnan(tf32_rna([np.nan]))[0]
    # the wrapper's torch version of the same rounding, bit for bit
    vals = np.array([c for c, _ in cases] + [-0.0, np.nan], np.float32)
    got_t = K._tf32_round(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got_t[:-1].view(np.uint32),
                                  tf32_rna(vals)[:-1].view(np.uint32))
    assert np.isnan(got_t[-1])


def test_split_error_bound_on_random_data():
    """big has 11 significant bits, small the next 11: |v - big - small| <= 2^-22 |v|,
    and a product taken as the kernel's three is within SPLIT_ERR |a| |b| of a b."""
    rng = np.random.RandomState(0)
    v = (rng.randn(200_000) * np.exp(rng.uniform(-20, 20, 200_000))).astype(np.float32)
    big, small = split(v)
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small.view(np.uint32) & 0x1FFF).any()
    v64, big64, small64 = (np.asarray(t, np.float64) for t in (v, big, small))
    assert (np.abs(v64 - big64) <= 2.0 ** -11 * np.abs(v64)).all()
    assert (np.abs(v64 - big64 - small64) <= 2.0 ** -22 * np.abs(v64)).all()
    a, b = v64[:100_000], v64[100_000:]
    (ab, as_), (bb, bs) = split(a.astype(np.float32)), split(b.astype(np.float32))
    three = (as_.astype(np.float64) * bb + ab.astype(np.float64) * bs
             + ab.astype(np.float64) * bb)
    err = np.abs(three - a * b)
    assert (err <= SPLIT_ERR * np.abs(a * b)).all()
    # one TF32 product alone loses up to 2^-10 relative: far beyond the 1e-4 limit's reach
    one = ab.astype(np.float64) * bb
    assert np.max(np.abs(one - a * b) / np.abs(a * b)) > 1e-4


def test_wrapper_split_matches_the_numpy_split():
    rng = np.random.RandomState(1)
    w = (rng.randn(16, 3, 31) * 0.05).astype(np.float32)
    got = K._split_tf32(torch.from_numpy(w))
    big, small = split(w)
    np.testing.assert_array_equal(got[0].numpy(), big)
    np.testing.assert_array_equal(got[1].numpy(), small)


@pytest.mark.parametrize("layer", range(5), ids=[f"enc{i + 1}" for i in range(5)])
def test_index_maps_match_plain_full_width_one_chunk(layer):
    """SEGAN+ widths at B = 1: split-K on enc2..enc5, the 1 x 8 tile on enc3..enc5."""
    _check_against_plain(*_inputs(*_main_path(1, layer), seed=layer))


def test_index_maps_match_plain_enc5_tiles_spanning_chunks():
    """enc5 at B = 3: 48 rows, three chunks in one m16 row of tiles."""
    _check_against_plain(*_inputs(*_main_path(3, 4), bias=True, seed=5))


@pytest.mark.parametrize("B,cin,t_in,cout,bias", [
    (3, 24, 91, 40, True),     # T_out 16: tap 31 of the last row reads sample 91 = T_in
    (2, 5, 1051, 64, False),   # T_out 256 on the 4 x 2 tile
    (5, 40, 4 * 47 + 31, 136, True),  # T_out 48, Cout 136: a partial warp of n8 tiles
], ids=["T_in=91", "T_in=1051", "T_out=48 Cout=136"])
def test_index_maps_match_plain_at_the_end_of_x(B, cin, t_in, cout, bias):
    assert (t_in - KW) % 4 == 0
    _check_against_plain(*_inputs(B, cin, t_in, cout, bias=bias, seed=B))


@pytest.mark.parametrize("num_sms", [132, 16])
def test_index_maps_match_plain_other_split_counts(num_sms):
    """enc3 at B = 2 with the splits that other cards' SM counts give."""
    _check_against_plain(*_inputs(*_main_path(2, 2), bias=True, seed=7), num_sms=num_sms)


@pytest.mark.parametrize("shift", [1, -1])
def test_a_window_off_by_one_sample_fails(shift):
    x, w, b, a = _inputs(*_main_path(1, 1), seed=11)
    with pytest.raises(AssertionError):
        _check_against_plain(x, w, b, a, shift=shift)


@pytest.mark.parametrize("bias", [True, False])
def test_emulation_matches_pallas_interpret(bias):
    """The JAX kernel (interpret mode, fp32) on its own layout: x (B, T, C)
    reflect-padded as its block pads it, w (K, Cin, Cout); T_out 64 takes the tensor-core
    route. Both sides are within ~1e-6 of the exact conv: 1e-5 relative."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 256, 4).astype(np.float32)
    w = (rng.randn(KW, 4, 8) / np.sqrt(KW * 4)).astype(np.float32)
    b = (rng.randn(8) * 0.1).astype(np.float32)
    a = rng.uniform(0, 0.3, 8).astype(np.float32)
    x_p = np.asarray(reflect_pad_1d(jnp.asarray(x), KW // 2 - 1, KW // 2))
    y_j, pre_j = plconv.fused_conv1d_prelu(
        jnp.asarray(x_p), jnp.asarray(w), jnp.asarray(b if bias else np.zeros_like(b)),
        jnp.asarray(a), 4, 256, True)
    y, pre = _emulate_tf32_kernel(np.ascontiguousarray(x_p.transpose(0, 2, 1)),
                                  np.ascontiguousarray(w.transpose(2, 1, 0)),
                                  b.astype(np.float64) if bias else None, a.astype(np.float64))
    assert pre.shape == (2, 8, 64)
    np.testing.assert_allclose(pre.transpose(0, 2, 1), np.asarray(pre_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.transpose(0, 2, 1), np.asarray(y_j), rtol=1e-5, atol=1e-5)


def test_tf32_taps_cover_the_padded_taps():
    taps = _tf32_taps()
    assert sorted(taps.ravel()) == list(range(K.KP))
    # lane quad q's taps over the four steps are 8q..8q+7: two 16-byte loads
    for q in range(4):
        assert sorted(taps[:, [q, q + 4]].ravel()) == list(range(8 * q, 8 * q + 8))


def test_emulated_constants_are_the_kernels():
    """Change the fp32 kernel's staging or tiles only together with its emulation."""
    src = (build.CSRC_DIR / "conv1d_prelu.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert (int(consts["WG"]), int(consts["STAGED_TF32"]), int(consts["MMA_MT"])) == (
        WG, STAGED_TF32, MMA_MT)
    # the mainloop's group windows: WG samples at stride 4 (WG_S2 at stride 2)
    assert "warp_conv_3xtf32<MMA_MT, S, W>" in src and "W = S == 4 ? WG : WG_S2" in src
    header = (build.CSRC_DIR / "mma_tf32.cuh").read_text()
    assert "m16n8k8.row.col.f32.tf32.tf32.f32" in header and "cvt.rna.tf32.f32" in header


@pytest.mark.parametrize("B", [1, 8, 64, 300])
@pytest.mark.parametrize("layer", range(5), ids=[f"enc{i + 1}" for i in range(5)])
def test_main_path_takes_the_tf32_route(B, layer):
    """fp32 takes the tensor cores at every main-path shape but enc1's FMA rows, with the
    bf16 mma.sync route's plan, in contiguous odd rows; in pitched rows the same but where
    the fp32 wgmma rule takes the shape (its own tests: test_torch_conv1d_wgmma_tf32.py)."""
    _, cin, t_in, cout = _main_path(B, layer)
    t_out = (t_in - KW) // 4 + 1
    enc1_fma = layer == 0 and B * t_out < K.ENC1_MMA_MIN_ROWS[torch.float32]
    wgmma = layer > 0 and (B * t_out >= K.WGMMA_MIN_ROWS[torch.float32] or
                           B * t_out * cout * cin >= K.WGMMA_MIN_WORK[torch.float32])
    assert K._route(torch.float32, B, cin, cout, KW, 4, t_out, False) == (
        "fma" if enc1_fma else "mma")
    assert K._route(torch.float32, B, cin, cout, KW, 4, t_out, True) == (
        "fma" if enc1_fma else "wgmma" if wgmma else "mma")
    warps_m, splits = K._mma_plan(B, cin, cout, t_out, H100_SMS)
    assert warps_m == {64: 4, 128: 2}.get(cout, 1)
    per = -(-cin // splits)
    assert -(-cin // per) == splits and (splits == 1 or per >= K.MMA_MIN_SLICE)


def test_padded_weights_are_split_once_per_weight_and_version():
    w = torch.randn(8, 3, 31)
    wp = K._padded_weights(w)
    assert K._padded_weights(w) is wp
    assert [v.shape for v in wp] == [(8, 3, 32)] * 2 and all(v.is_contiguous() for v in wp)
    padded = K._pad_taps(w)
    for got, want in zip(wp, split(padded.numpy())):
        np.testing.assert_array_equal(got.numpy(), want)
    assert ((wp[0].double() + wp[1] - padded).abs() <= 2.0 ** -22 * padded.abs()).all()
    assert not wp[0][..., 31:].any() and not wp[1][..., 31:].any()  # the padded tap: 0
    with torch.no_grad():
        w.mul_(3)
    assert not torch.equal(K._padded_weights(w)[0], wp[0])


class _FakeLib:
    """The library's entry points, recording their calls."""

    def __init__(self):
        self.calls = []

    def entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("dtype,entry", [(torch.float32, "tf32"), (torch.bfloat16, "rows")])
def test_launch_dispatches_by_dtype_and_counts(monkeypatch, dtype, entry):
    """Without a card: the wrapper's dispatch with the library replaced. fp32 main-path
    shapes call the 3xTF32 entry with both parts of the split weights and count in
    launches, launches_mma and launches_tf32; bf16 (16 rows) calls the rows entry with
    its weights' tensor map; force="fma" the FMA kernel."""
    lib = _FakeLib()
    monkeypatch.setattr(K, "_entries", lambda: tuple(
        lib.entry(n) for n in ("fma", "splits", "mma", "tf32")))
    monkeypatch.setattr(K, "_rows_entries", lambda: (lib.entry("rows_encode"),
                                                      lib.entry("rows")))
    monkeypatch.setattr(K, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(K, "_records", {})  # records hold the entry points they call
    monkeypatch.setattr(K, "_current_device", lambda: None)  # x's index on the CPU
    monkeypatch.setattr(K, "_current_stream", lambda index: 0)
    x, w, _, a = (torch.from_numpy(v).to(dtype) if v is not None else None
                  for v in _inputs(*_main_path(1, 4), seed=2))
    before = (K.launches, K.launches_mma, K.launches_tf32)
    K._launch(x, w, None, a, 4, 16)
    name, args = lib.calls[-1]
    assert name == entry
    is_tf32 = entry == "tf32"
    assert (K.launches, K.launches_mma, K.launches_tf32) == (
        before[0] + 1, before[1] + 1, before[2] + is_tf32)
    wp = K._padded_weights(w)
    if is_tf32:
        assert args[1:3] == (wp[0].data_ptr(), wp[1].data_ptr())
        assert args[8:10] == K._mma_plan(1, 512, 1024, 16, H100_SMS)
    else:
        assert args[1] == K._rows_weights(w)[2]
        assert torch.equal(K._rows_weights(w)[0], K._rows_tiles(w))
        assert args[6:9] == K._rows_plan(1, 512, 1024, 16, H100_SMS)
    lib.calls.clear()
    K._launch(x, w, None, a, 4, 16, force="fma")
    assert [n for n, _ in lib.calls] == ["splits", "fma"]
    assert K.launches_tf32 == before[2] + is_tf32


def test_ab_tool_tf32_variants_apply_to_the_kernel_source():
    """Each fp32 variant of tools/conv1d_mma_ab.py is the kernel's source and mainloop
    with its edits, all inside conv1d_tf32_kernel or csrc/mma_tf32.cuh: the edits must
    keep matching them."""
    sources = ab.tf32_variant_sources()
    assert list(sources) == ["as is", "w split in registers", "x split at staging",
                             "stores through shared memory", "one sum in the tensor cores",
                             "fresh sums from a zero C", "1 block per SM", "1xTF32"]
    cu0, cuh0 = sources["as is"]
    assert cu0 == (build.CSRC_DIR / "conv1d_prelu.cu").read_text()
    assert cuh0 == (build.CSRC_DIR / "mma_tf32.cuh").read_text()
    assert len(set(sources.values())) == len(sources)  # every variant changed something
    start = cu0.index(ab.REGIONS["float32"][0])
    for name, (cu, cuh) in sources.items():
        assert cu[:start] == cu0[:start], name  # the bf16 and FMA kernels untouched
        edits = ab.TF32_EDITS[name]
        for where, _, new in edits if isinstance(edits, list) else ():
            assert new in (cu if where == "cu" else cuh), name
    assert "float4" in sources["stores through shared memory"][0][start:]
    assert "mma_tf32(c, a_small" in cuh0 and "mma_tf32(c, a_small" not in sources["1xTF32"][1]
