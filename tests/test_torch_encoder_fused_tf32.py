"""The fp32 tensor-core route of the port's chained enc2 + enc3 op
(segan_pytorch_tpu_torch/csrc/encoder_fused.cu, ``enc23_tf32_kernel<TILE>``, mainloop
``warp_conv_3xtf32`` in csrc/mma_tf32.cuh): its index maps, route, tile rule and dispatch.

No card here: a float64 emulation of exactly the kernel's index maps at both tiles (the
h1 window staged CC channels at a time and reflected at T1, post2 by padded slot with the
mirror fill at T2, the A operand at 4 m + tap, the 32 padded taps in the order the
m16n8k8 fragments take them, phase A's 2 x 4 warps in passes of at most 3 m16 tiles and
phase B's 8 warps) with every operand split into its two TF32 parts (post2 rounded to
fp32 and split again for enc3) is held against the plain version in float64 and against
the JAX Pallas kernel in interpret mode. The numpy ``cvt.rna`` rounding, the split and
its bound come from tests/test_torch_conv1d_tf32.py. On the card chip_smoke.py holds the
kernel itself against the plain version and, at batch 300, pre3 against float64.
"""
import contextlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench
from test_torch_conv1d_tf32 import SPLIT_ERR, _tf32_taps, split
from test_torch_encoder_fused import (_from_port, _jax_fused, _jax_inputs, _prelu,
                                      _reflect, _to_port)

# enc23_tf32_kernel's constants by tile, as in csrc/encoder_fused.cu
TILES = {16: dict(SLOTS=92, MA=96, WIN=412, CC=16),
         32: dict(SLOTS=156, MA=160, WIN=668, CC=8)}
PT = 3  # phase A: m16 tiles per warp and pass
H100_SMS = 132


def _contract(a_big, a_small, m, w_big, w_small):
    """The kernel's sum over input channels and the 32 taps, as its four 8-deep steps of
    three MMAs (small x big, big x small, big x big): A operand of row m, channel ci and
    tap k at a[ci, 4 m + k]; a (ch, window), w (n, ch, 32); returns (rows, n)."""
    dot = lambda a, w: np.tensordot(a, w, axes=([0, 2], [1, 2]))
    acc = 0.0
    for taps in _tf32_taps():
        idx = 4 * m + taps
        ab, as_ = a_big[:, idx], a_small[:, idx]
        wb, ws = w_big[:, :, taps], w_small[:, :, taps]
        acc = acc + dot(as_, wb) + dot(ab, ws) + dot(ab, wb)
    return acc


def _exact(a, m, w):
    """The same contraction without the split, in float64: sum of a[ci, 4 m + k] w[n, ci, k]."""
    return sum(np.tensordot(a[:, 4 * m + t], w[:, :, t], axes=([0, 2], [1, 2]))
               for t in _tf32_taps())


def _split64(v):
    return tuple(p.astype(np.float64) for p in split(v))


def _emulate_tf32_kernel(h1, w2, b2, a2, w3, b3, a3, tile, shift=0):
    """What enc23_tf32_kernel<tile> computes, block by block, in float64 numpy (port
    layout) from float32 inputs: pre2, pre3, post3 (NaN where no warp writes), and for
    enc3 what each block's own post2 slots (fp32) give without the split (own3, bias
    included) and sum|post2| |w3| (mag3). Products of TF32 parts are exact in float64, so
    what differs from the exact chain is the split alone; the rounding of the kernel's
    fp32 sums is the card's to show. `shift` moves every staged h1 window by that many
    samples (a mutation the comparisons must catch)."""
    c = TILES[tile]
    SLOTS, MA, WIN, CC = c["SLOTS"], c["MA"], c["WIN"], c["CC"]
    RT = MA // 32
    B, C1, T1 = h1.shape
    C2, C3 = w2.shape[0], w3.shape[0]
    T2, T3 = T1 // 4, T1 // 16
    assert EF._route(torch.float32, C2, C3) == "tf32"
    pad = lambda w: K._pad_taps(torch.from_numpy(np.asarray(w, np.float32))).numpy()
    (w2b, w2s), (w3b, w3s) = _split64(pad(w2)), _split64(pad(w3))
    w3p = pad(w3).astype(np.float64)
    b2 = np.zeros(C2) if b2 is None else b2.astype(np.float64)
    b3 = np.zeros(C3) if b3 is None else b3.astype(np.float64)
    pre2 = np.full((B, C2, T2), np.nan)
    pre3, post3, own3, mag3 = (np.full((B, C3, T3), np.nan) for _ in range(4))
    for b in range(B):
        for t0 in range(0, T3, tile):
            t_end = min(t0 + tile, T3)
            p0 = 4 * t0 - 14  # the real post2 row of slot 0
            lo, hi = max(0, p0), min(T2 - 1, p0 + SLOTS - 1)
            rows = hi - lo + 1
            # phase A, rows m < MA: window row j is padded h1 row 4 lo + j
            win = np.clip(_reflect(4 * lo + np.arange(WIN) - 14 + shift, T1), 0, T1 - 1)
            m = np.arange(MA)[:, None]
            acc = np.zeros((MA, C2))
            for c0 in range(0, C1, CC):
                xb, xs = _split64(h1[b, c0:c0 + CC][:, win])
                acc += _contract(xb, xs, m, w2b[:, c0:c0 + CC], w2s[:, c0:c0 + CC])
            written = np.zeros((MA, C2), bool)  # the rows and channels a warp stores
            for nb in range(0, C2, 128):
                for warp in range(8):
                    n0 = nb + (warp % 4) * 32
                    nt_live = min(4, max(0, (C2 - n0) // 8))
                    for pss in range(-(-RT // PT)):
                        ma0 = ((warp // 4) * RT + pss * PT) * 16
                        mt_live = min(PT, RT - pss * PT, max(0, -(-(rows - ma0) // 16)))
                        written[ma0:ma0 + 16 * mt_live, n0:n0 + 8 * nt_live] = True
            written[rows:] = False
            pre = np.where(written, acc + b2, np.nan)[:rows]
            post2 = np.full((C2, SLOTS), np.nan)  # slot s: padded post2 row 4 t0 + s
            post2[:, lo - p0:hi - p0 + 1] = _prelu(pre, a2).T
            pre2[b, :, 4 * t0:4 * t_end] = pre[4 * t0 - lo:4 * t_end - lo].T
            for s in range(SLOTS):
                r = p0 + s
                if lo <= r <= hi:
                    continue
                src = -r if r < 0 else 2 * T2 - 2 - r
                post2[:, s] = post2[:, src - p0] if lo <= src <= hi else 0.0
            assert not np.isnan(post2).any(), "a real post2 row that no warp wrote"
            post2 = post2.astype(np.float32)  # fp32 in shared memory, split as it is read
            # phase B: rows m < tile, those past t_end discarded; 8 warps of 32 channels
            m = np.arange(tile)[:, None]
            pb, ps = _split64(post2)
            n = t_end - t0
            acc = _contract(pb, ps, m, w3b, w3s)[:n]
            live = np.zeros(C3, bool)
            for n0 in range(0, -(-C3 // 256) * 256, 32):
                live[n0:n0 + 8 * min(4, max(0, (C3 - n0) // 8))] = True
            pre = np.where(live, acc + b3, np.nan)
            pre3[b, :, t0:t_end] = pre.T
            post3[b, :, t0:t_end] = _prelu(pre, a3).T
            own3[b, :, t0:t_end] = (_exact(post2.astype(np.float64), m, w3p)[:n] + b3).T
            mag3[b, :, t0:t_end] = _exact(np.abs(post2.astype(np.float64)), m,
                                          np.abs(w3p))[:n].T
    return dict(pre2=pre2, pre3=pre3, post3=post3, own3=own3, mag3=mag3)


def _conv_abs(x, w):
    """sum |x| |w| over each output's window of the reflect-padded x, in float64."""
    x = EF.reflect_pad_1d(torch.from_numpy(np.abs(x)), *EF.PAD)
    return F.conv1d(x, torch.from_numpy(np.abs(w).astype(np.float64)), stride=4).numpy()


def _check_against_plain(h1, w2, b2, a2, w3, b3, a3, tile, **emulate):
    """The emulation vs the exact chain (enc23_plain in float64 on the same float32
    values). pre2 within SPLIT_ERR sum |h1| |w2| over its window. enc3 twice: against the
    exact enc3 of the block's own fp32 post2 within SPLIT_ERR sum |post2| |w3| (its own
    split), and against the exact chain within that plus post2's error carried through
    |w3| (enc2's split and the rounding of post2 to fp32, 2^-24 relative). post3 within
    pre3's bounds (slopes in [0, 1)). The port's fp32 limit of 1e-4 relative met with a
    margin of 100."""
    emu = _emulate_tf32_kernel(h1, w2, b2, a2, w3, b3, a3, tile, **emulate)
    t = lambda v: None if v is None else torch.from_numpy(v).double()
    pre2_ref, pre3_ref, post3_ref = (v.numpy() for v in EF.enc23_plain(
        t(h1), t(w2), t(b2), t(a2), t(w3), t(b3), t(a3)))
    post2_ref = _prelu(pre2_ref, a2[None, :, None])
    bound2 = SPLIT_ERR * _conv_abs(h1.astype(np.float64), w2) + 1e-12
    carried = _conv_abs(bound2 + 2.0 ** -24 * np.abs(post2_ref), w3)
    own = SPLIT_ERR * emu["mag3"] + 1e-12
    for name, got in emu.items():
        if name in ("pre2", "pre3", "post3"):
            assert not np.isnan(got).any(), f"{name}: rows no warp writes"
    err = lambda got, ref, bound: np.max(np.abs(got - ref) / bound)
    assert err(emu["pre2"], pre2_ref, bound2) <= 1, err(emu["pre2"], pre2_ref, bound2)
    assert err(emu["pre3"], emu["own3"], own) <= 1, err(emu["pre3"], emu["own3"], own)
    post3_own = _prelu(emu["own3"], a3[None, :, None])
    assert err(emu["post3"], post3_own, own) <= 1
    for got, ref in ((emu["pre3"], pre3_ref), (emu["post3"], post3_ref)):
        assert err(got, ref, own + carried) <= 1, err(got, ref, own + carried)
    for got, ref in ((emu["pre2"], pre2_ref), (emu["pre3"], pre3_ref),
                     (emu["post3"], post3_ref)):
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def _f32_inputs(B, T1, C1, C2, C3, bias, seed=0):
    return [None if v is None else v.numpy()
            for v in _to_port(*_jax_inputs(B, T1, C1, C2, C3, bias, seed))]


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("B,T1,C1,C2,C3,bias", [
    (1, 4096, 64, 128, 256, False),  # SEGAN+ widths: 16 or 8 tiles
    (3, 64, 5, 24, 40, True),        # one tile touching both mirrored ends
    (2, 592, 5, 24, 40, False),      # a last tile of 5 rows
], ids=["full width B=1", "T1=64", "ragged T1=592"])
def test_index_maps_match_plain(B, T1, C1, C2, C3, bias, tile):
    _check_against_plain(*_f32_inputs(B, T1, C1, C2, C3, bias, seed=B), tile=tile)


@pytest.mark.parametrize("shift", [1, -1])
def test_a_window_off_by_one_sample_fails(shift):
    with pytest.raises(AssertionError):
        _check_against_plain(*_f32_inputs(2, 592, 5, 24, 40, True, seed=9), tile=16,
                             shift=shift)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("bias", [True, False])
def test_emulation_matches_pallas_interpret(bias, tile):
    """tests/test_pallas.py's shapes (B 4, T1 256, C 8/16/32) through the JAX kernel in
    interpret mode, fp32: both sides within ~1e-6 of the exact chain, so 1e-5."""
    inputs = _jax_inputs(4, 256, 8, 16, 32, bias)
    want = _jax_fused(*inputs)
    port = [None if v is None else v.numpy() for v in _to_port(*inputs)]
    emu = _emulate_tf32_kernel(*port, tile=tile)
    for name, w in zip(("pre2", "pre3", "post3"), want):
        np.testing.assert_allclose(emu[name].transpose(0, 2, 1), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_emulated_constants_are_the_kernels():
    """Change the fp32 chained kernel's staging, slots or tiles only together with its
    emulation."""
    src = (build.CSRC_DIR / "encoder_fused.cu").read_text()
    found = {int(t): dict((k, int(v)) for k, v in re.findall(r"(\w+) = (\d+)", body))
             for t, body in re.findall(
                 r"struct Tf32Tile<(\d+)> \{\s*static constexpr int ([^;]*);\s*\};", src)}
    assert found == TILES
    assert int(re.search(r"constexpr int PT = (\d+);", src).group(1)) == PT
    for tile, c in TILES.items():
        assert c["SLOTS"] == 4 * tile + EF.KP - 4
        assert c["MA"] == 32 * -(-c["SLOTS"] // 32) and c["WIN"] == 4 * (c["MA"] - 1) + EF.KP
    assert '#include "mma_tf32.cuh"' in src
    assert "warp_conv_3xtf32<PT>(acc, xs, P::WIN, ma0, mt_live" in src
    assert "warp_conv_3xtf32<MTB>(acc, post2, P::SLOTS, 0, mt_live_b" in src


@pytest.mark.parametrize("dtype,c2,c3,route", [
    (torch.float32, 128, 256, "tf32"),   # SEGAN+ widths
    (torch.float32, 24, 40, "tf32"),     # the smoke's narrow shapes
    (torch.float32, 24, 36, "fma"),      # C3 not whole n8 tiles
    (torch.float32, 20, 40, "fma"),      # C2 not whole n8 tiles
    (torch.bfloat16, 128, 256, "mma"),   # bf16 as before
    (torch.bfloat16, 24, 36, "mma"),     # ... which _launch refuses
])
def test_route_rule(dtype, c2, c3, route):
    assert EF._route(dtype, c2, c3) == route


@pytest.mark.parametrize("B,tile", [(1, 16), (16, 16), (17, 32), (32, 32), (33, 32),
                                    (300, 32)])
def test_tile_rule_at_segan_widths(B, tile):
    """TILE 16 while the TILE 32 grid (B x 8 blocks at T1 = 4096) has fewer blocks than
    an H100 has SMs."""
    assert EF._tf32_tile(B, 4096, H100_SMS) == tile


class _FakeLib:
    """The library's two entry points, recording their calls."""

    def __init__(self):
        self.calls = []

    def entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrapper without a card: the library replaced, an H100's SM count, and CUDA's
    device and stream calls stubbed."""
    lib = _FakeLib()
    monkeypatch.setattr(EF, "_entries", lambda: (lib.entry("launch"), lib.entry("tf32")))
    monkeypatch.setattr(EF, "_sm_count", lambda index: H100_SMS)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    return lib


def _torch_inputs(B, T1, C1, C2, C3, dtype=torch.float32, bias=True):
    return [None if v is None else torch.from_numpy(v).to(dtype)
            for v in _f32_inputs(B, T1, C1, C2, C3, bias)]


def _counters():
    return EF.launches, EF.launches_tf32, EF.launches_tile16


def test_launch_dispatches_by_route_and_counts(fake_lib):
    """fp32 with whole n8 tiles calls the 3xTF32 entry with both parts of both split
    weights and the tile by batch, and counts in launches and launches_tf32 (and
    launches_tile16 at 16); tile= sets the tile; force="fma" and C3 = 36 call the FMA
    kernel (dtype 0) with the weights as they are; bf16 its kernel (dtype 1) with the
    padded weights."""
    h1, w2, b2, a2, w3, b3, a3 = args = _torch_inputs(1, 4096, 4, 16, 24)
    before = _counters()
    EF._launch(*args)
    name, call = fake_lib.calls[-1]
    (w2b, w2s), (w3b, w3s) = K._padded_weights(w2), K._padded_weights(w3)
    assert name == "tf32" and call[1:3] == (w2b.data_ptr(), w2s.data_ptr())
    assert call[3:9] == (b2.data_ptr(), a2.data_ptr(), w3b.data_ptr(), w3s.data_ptr(),
                         b3.data_ptr(), a3.data_ptr())
    assert call[12:18] == (16, 1, 4, 4096, 16, 24)
    assert _counters() == (before[0] + 1, before[1] + 1, before[2] + 1)
    EF._launch(*args, tile=32)
    assert fake_lib.calls[-1][1][12] == 32
    assert _counters() == (before[0] + 2, before[1] + 2, before[2] + 1)
    EF._launch(*args, force="fma")
    name, call = fake_lib.calls[-1]
    assert name == "launch" and call[0] == 0 and call[2] == w2.data_ptr()
    assert _counters() == (before[0] + 3, before[1] + 2, before[2] + 1)
    odd = _torch_inputs(1, 64, 4, 16, 36, bias=False)
    EF._launch(*odd)
    name, call = fake_lib.calls[-1]
    assert name == "launch" and call[0] == 0 and call[3] is None
    assert _counters() == (before[0] + 4, before[1] + 2, before[2] + 1)
    bf = [v.bfloat16() for v in args]
    EF._launch(*bf)
    name, call = fake_lib.calls[-1]
    assert name == "launch" and call[0] == 1
    assert call[2] == K._padded_weights(bf[1]).data_ptr()
    assert call[5] == K._padded_weights(bf[4]).data_ptr()
    assert _counters() == (before[0] + 5, before[1] + 2, before[2] + 1)


@pytest.mark.parametrize("kwargs,dtype", [
    (dict(tile=8), torch.float32),              # no such tile
    (dict(tile=16, force="fma"), torch.float32),  # a tile for the FMA kernel
    (dict(tile=16), torch.bfloat16),            # the bf16 kernel's tile is fixed
    (dict(force="fma"), torch.bfloat16),        # the FMA route is fp32's
])
def test_launch_rejects_a_private_switch_off_its_route(fake_lib, kwargs, dtype):
    before = _counters()
    with pytest.raises(ValueError):
        EF._launch(*_torch_inputs(1, 64, 4, 16, 24, dtype), **kwargs)
    assert _counters() == before and not fake_lib.calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weights_are_padded_once_per_weight_and_version(fake_lib, monkeypatch, dtype):
    """Both tensor-core kernels take w2 and w3 padded (and in fp32 split) once while
    they live unchanged: at one chunk a pad on every call costs as much host time as
    the kernel."""
    pads = []
    pad_taps = K._pad_taps
    monkeypatch.setattr(K, "_pad_taps", lambda w: pads.append(w.shape) or pad_taps(w))
    args = _torch_inputs(1, 64, 4, 16, 24, dtype)
    for _ in range(3):
        EF._launch(*args)
    assert pads == [(16, 4, 31), (24, 16, 31)]
    idx = (1, 2, 5, 6) if dtype == torch.float32 else (2, 5)  # the weights' pointers
    ptrs = [tuple(call[i] for i in idx) for _, call in fake_lib.calls]
    assert ptrs[0] == ptrs[1] == ptrs[2]
    with torch.no_grad():
        args[4].mul_(2)  # a new version of w3: padded anew
    EF._launch(*args)
    assert pads == [(16, 4, 31), (24, 16, 31), (24, 16, 31)]


@pytest.mark.parametrize("B,C3,dtype,want", [
    (1, 24, torch.float32, ("tf32", 16)),
    (40, 24, torch.float32, ("tf32", 32)),
    (1, 36, torch.float32, ("fma", 32)),
    (1, 24, torch.bfloat16, ("mma", 32)),
])
def test_tool_reads_route_and_tile_from_the_counters(fake_lib, B, C3, dtype, want):
    args = _torch_inputs(B, 4096, 2, 16, C3, dtype)
    assert bench.route_taken(lambda: EF._launch(*args), dtype) == want
    with pytest.raises(RuntimeError, match="launched 0 times"):
        bench.route_taken(lambda: None, dtype)
