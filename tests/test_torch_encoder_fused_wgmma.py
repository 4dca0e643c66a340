"""The bf16 wgmma route of the port's chained enc2 + enc3 op
(segan_pytorch_tpu_torch/csrc/encoder_fused_wgmma.cu, ``enc23_wgmma_kernel``), its route
rule and dispatch, and the A/B tool's pitched "kernel x2" arm.

No card here: a float64 numpy emulation of exactly the kernel's maps (phase A's h1 boxes
of 96 samples x 2 channels per m16 group, each starting on a 16-byte boundary 2 samples
before its window, TMA's zeros outside [0, T1), the reflect written into the landed boxes
at either end, each lane's A fragments and the permuted w2 as the
per-layer wgmma kernel takes them; post2 stored by slot into the folded tile through the
kernel's address function and read back by phase B's descriptors (LBO, SBO and the
q x 16-byte start of folded tap q), the mirror fill at T2, w3 folded) is held against the
plain version and against the JAX Pallas kernel in interpret mode. Mutations of the
descriptor start and of the folded depth order must fail. On the card chip_smoke.py holds
the kernel itself against the plain version and against the pitched per-layer pair.
"""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from segan_pytorch_tpu.ops.pallas import encoder_fused as jef
from segan_pytorch_tpu_torch.ops import conv as conv_ops
from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench
from test_torch_conv1d_wgmma import _a_index
from test_torch_encoder_fused import _from_port, _jax_fused, _jax_inputs, _prelu, _to_port

SRC = build.CSRC_DIR / "encoder_fused_wgmma.cu"
ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132
# enc23_wgmma_kernel's constants, as in csrc/encoder_fused_wgmma.cu
(C2, C3, TILE, SLOTS, FROWS, A_GROUPS, CC, WIN, XOFF, W_BOX, STAGES, A_PASSES,
 A_BOXES) = 128, 256, 64, 284, 71, 20, 2, 96, 2, 64, 4, 3, 8
LBO, SBO = FROWS * 16, 128  # post2's descriptor: bytes between chunks, 8-row groups


def post2_offset(p, c, swap=False):
    """The byte where folded slot p, channel c of post2 lies (the kernel's
    ``post2_offset``): chunk (s C2 + c) / 8 of folded row p / 4, s = p % 4; with `swap`
    the depth index c 4 + s in place of s C2 + c (a mutation)."""
    s, u = p % 4, p // 4
    depth = c * 4 + s if swap else s * C2 + c
    return (depth // 8) * LBO + u * 16 + (depth % 8) * 2


def desc_a(start, rows=64, lbo=LBO, sbo=SBO):
    """The bytes that a no-swizzle K-major descriptor at `start` gives a 64 x 16 bf16
    tile: row m, depth k at start + (m % 8) 16 + (m // 8) SBO + (k // 8) LBO + (k % 8) 2."""
    m, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    return start + (m % 8) * 16 + (m // 8) * sbo + (k // 8) * lbo + (k % 8) * 2


def _emulate_wgmma_kernel(h1, w2, b2, a2, w3, b3, a3, start_shift=0, swap=False,
                          xoff=XOFF):
    """What enc23_wgmma_kernel computes, block by block, in float64 numpy (port layout):
    (pre2, pre3, post3), NaN where no block stores. A window wholly past T1 is not loaded
    (NaN here, as its stale bytes there: only rows the mirror fill overwrites read it).
    `start_shift` moves every phase B A descriptor by that many bytes, `swap` stores post2
    at depth c 4 + s, `xoff` reads phase A's windows from that sample of their boxes
    (mutations the comparisons must catch)."""
    B, C1, T1 = h1.shape
    assert (w2.shape[0], w3.shape[0]) == (C2, C3)
    T2, T3 = T1 // 4, T1 // 16
    w2p = K._wgmma_weights(torch.from_numpy(w2)).numpy()  # (C2, C1, 32), permuted taps
    w3f = EF._fold_w3(torch.from_numpy(w3)).numpy()        # (C3, 4096)
    b2 = np.zeros(C2) if b2 is None else b2
    b3 = np.zeros(C3) if b3 is None else b3
    a_idx = _a_index()  # (step h, row of the m16 group, k) -> window sample
    pre2 = np.full((B, C2, T2), np.nan)
    pre3, post3 = np.full((B, C3, T3), np.nan), np.full((B, C3, T3), np.nan)
    for b in range(B):
        for t0 in range(0, T3, TILE):
            t_end = min(t0 + TILE, T3)
            p0 = 4 * t0 - 14
            lo, hi = max(0, p0), min(T2 - 1, p0 + SLOTS - 1)
            x0 = 4 * p0 - 14 - XOFF  # group 0's box: XOFF samples before its window
            assert x0 % 8 == 0  # TMA starts a box on a 16-byte boundary
            # phase A: the TMA box of each m16 group, channels padded to whole stages
            c1p = -(-C1 // CC) * CC
            h = np.zeros((c1p, T1))
            h[:C1] = h1[b]
            boxes = np.zeros((A_GROUPS, c1p, WIN))
            for q in range(A_GROUPS):
                start = x0 + 64 * q
                samp = start + np.arange(WIN)
                if start >= T1:
                    boxes[q] = np.nan
                    continue
                inside = (samp >= 0) & (samp < T1)
                boxes[q][:, inside] = h[:, samp[inside]]
                for i, s in enumerate(samp):  # the reflect written into the landed window
                    src = -s if -14 <= s < 0 else (2 * T1 - 2 - s if T1 <= s < T1 + 15
                                                   else None)
                    if src is not None and 0 <= src - start < WIN:
                        boxes[q][:, i] = boxes[q][:, src - start]
            wp = np.zeros((C2, c1p, 32))
            wp[:, :C1] = w2p
            acc = np.zeros((A_GROUPS * 16, C2))
            for h_ in range(2):  # each group's 16 rows; channel and tap summed in the step
                A = boxes[:, :, xoff + a_idx[h_]]  # (group, channel, row, k)
                acc += np.einsum("qcrk,nck->qrn", A, wp[:, :, 16 * h_:16 * h_ + 16]).reshape(
                    A_GROUPS * 16, C2)
            pre = acc + b2
            post2 = np.full(64 * LBO // 2 + 8, np.nan)  # and what follows it (barriers)
            c = np.arange(C2)
            for p in range(SLOTS):  # every slot of phase A's rows, real or not
                post2[post2_offset(p, c, swap) // 2] = _prelu(pre[p], a2)
                r = p0 + p
                if 4 * t0 <= r < 4 * t_end:
                    pre2[b, :, r] = pre[p]
            for p in range(SLOTS):  # the mirror fill
                r = p0 + p
                if lo <= r <= hi:
                    continue
                src = -r if r < 0 else 2 * T2 - 2 - r
                post2[post2_offset(p, c, swap) // 2] = (
                    post2[post2_offset(src - p0, c, swap) // 2] if lo <= src <= hi else 0.0)
            # phase B: stage it, step kk: A by descriptor, B the 16 depths of w3f
            acc = np.zeros((TILE, C3))
            for it in range(64):
                q, chunk = it // 8, (it % 8) * 8
                for kk in range(4):
                    start = (chunk + 2 * kk) * LBO + 16 * q + start_shift
                    A = post2[desc_a(start) // 2]
                    acc += A @ w3f[:, 64 * it + 16 * kk:64 * it + 16 * kk + 16].T
            pre_b = acc[:t_end - t0] + b3
            pre3[b, :, t0:t_end] = pre_b.T
            post3[b, :, t0:t_end] = _prelu(pre_b, a3).T
    return pre2, pre3, post3


def _inputs(B, T1, C1, bias, seed=0):
    """float64 numpy inputs in the port's layout at the kernel's widths."""
    return [None if v is None else np.ascontiguousarray(v).astype(np.float64)
            for v in (t.numpy() if t is not None else None
                      for t in _to_port(*_jax_inputs(B, T1, C1, C2, C3, bias, seed)))]


def _plain(args):
    t = lambda v: None if v is None else torch.from_numpy(v)
    return [v.numpy() for v in EF.enc23_plain(*map(t, args))]


CASES = {
    "T1=64": (3, 64, 5, True),      # one tile: both edges, most boxes past T1, C1 odd
    "T1=256": (2, 256, 8, False),   # one tile of 16 rows
    "ragged T1=1168": (2, 1168, 8, True),  # T3 = 73: a last tile of 9 rows, T3 % 8 != 0
    "T1=4096": (1, 4096, 64, False),  # SEGAN+ widths: 4 tiles, interior ones
}


@pytest.mark.parametrize("case", list(CASES))
def test_index_maps_match_plain(case):
    args = _inputs(*CASES[case])
    got = _emulate_wgmma_kernel(*args)
    for g, w in zip(got, _plain(args)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10)


def test_emulation_matches_pallas_interpret():
    """The JAX kernel on the same float32 numbers, in interpret mode: 1e-5, two
    implementations summing in different orders in fp32 and float64."""
    inputs = _jax_inputs(2, 256, 8, C2, C3, True, seed=3)
    want = _jax_fused(*inputs)
    got = _emulate_wgmma_kernel(*[None if v is None else v.numpy().astype(np.float64)
                                  for v in _to_port(*inputs)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(0, 2, 1), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mutation", [dict(start_shift=16), dict(start_shift=-16),
                                      dict(swap=True), dict(xoff=XOFF + 1),
                                      dict(xoff=XOFF - 1)],
                         ids=["start one row on", "start one row back", "s and c swapped",
                              "window one sample on", "window one sample back"])
def test_a_wrong_map_fails(mutation):
    args = _inputs(1, 256, 8, False, seed=1)
    got = _emulate_wgmma_kernel(*args, **mutation)
    want = _plain(args)
    k = 0 if "xoff" in mutation else 1  # phase A's maps show in pre2, phase B's in pre3
    assert not np.allclose(got[k], want[k], rtol=1e-3, atol=1e-3)


def test_descriptor_reads_rows_16_bytes_apart():
    """Within a chunk the folded rows lie 16 bytes apart, so moving the start by 16 q
    bytes reads rows q .. q + 63: the 8-row groups of a descriptor (SBO 128) and its two
    chunks (LBO) then cover the tile as the folded layout stores it."""
    for q in range(8):
        for chunk in (0, 6, 62):
            got = desc_a(chunk * LBO + 16 * q)
            m, k = np.arange(64)[:, None], np.arange(16)[None, :]
            want = (chunk + k // 8) * LBO + (m + q) * 16 + (k % 8) * 2
            assert (got == want).all()
    assert (FROWS - 1) * 16 < LBO and 63 + 7 < FROWS  # rows m + q of every tap inside


def test_folded_w3_is_the_pallas_fold_transposed():
    w3 = np.random.RandomState(5).randn(31, 16, 24).astype(np.float32)  # JAX (K, Cin, Cout)
    want = np.asarray(jef._fold_weights(w3))  # (8, 4 Cin, Cout)
    got = EF._fold_w3(torch.from_numpy(np.ascontiguousarray(w3.transpose(2, 1, 0))))
    assert got.shape == (24, 8 * 4 * 16) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1, 24).T)


def test_emulated_constants_are_the_kernels():
    """Change the kernel's tile, ring, boxes or post2 layout only together with its
    emulation."""
    src = SRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    names = ("C2", "C3", "TILE", "SLOTS", "FROWS", "A_GROUPS", "CC", "WIN", "XOFF", "W_BOX",
             "STAGES", "A_PASSES", "A_BOXES")
    assert [int(consts[n]) for n in names] == [C2, C3, TILE, SLOTS, FROWS, A_GROUPS, CC,
                                               WIN, XOFF, W_BOX, STAGES, A_PASSES, A_BOXES]
    assert "constexpr int LBO = FROWS * 16;" in src
    assert "desc_plain(post2 + (chunk + 2 * kk) * LBO + 16 * q, LBO, 128)" in src
    assert (EF.WGMMA_C2, EF.WGMMA_C3, EF.WGMMA_TILE) == (C2, C3, TILE)
    for op in ("m64n128k16", "m64n64k16"):
        assert f"wgmma.mma_async.sync.aligned.{op}.f32.bf16.bf16" in src
    assert '#include "tma_ring.cuh"' in src and "__grid_constant__" in src


def test_module_and_tool_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|segan_pytorch_tpu)\b(?!_torch)",
                     re.M)
    files = [ROOT / "segan_pytorch_tpu_torch/ops/kernels/encoder_fused.py",
             ROOT / "segan_pytorch_tpu_torch/tools/encoder_fused_bench.py"]
    assert not [f for f in files if pat.search(f.read_text())]
    assert "jax" not in SRC.read_text().lower().replace("the jax kernel", "")


@pytest.mark.parametrize("dtype,c2,c3,rows,aligned,route", [
    (torch.bfloat16, 128, 256, 1 << 20, True, "wgmma"),   # SEGAN+ widths
    (torch.bfloat16, 128, 256, EF.WGMMA_MIN_ROWS, True, "wgmma"),
    (torch.bfloat16, 128, 256, EF.WGMMA_MIN_ROWS - 1, True, "mma"),
    (torch.bfloat16, 128, 256, 1 << 20, False, "mma"),    # h1 off 16 bytes
    (torch.bfloat16, 64, 256, 1 << 20, True, "mma"),      # other widths
    (torch.bfloat16, 128, 512, 1 << 20, True, "mma"),
    (torch.float32, 128, 256, 1 << 20, True, "wgmma_tf32"),  # fp32: its own wgmma kernel
])
def test_route_rule(dtype, c2, c3, rows, aligned, route):
    assert EF._route(dtype, c2, c3, rows, aligned) == route


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
    """The wrapper without a card: both libraries replaced, an H100's SM count, CUDA's
    device and stream calls stubbed."""
    lib = _FakeLib()
    monkeypatch.setattr(EF, "_entries", lambda: (lib.entry("launch"), lib.entry("tf32")))
    monkeypatch.setattr(EF, "_wgmma_entry", lambda: lib.entry("wgmma"))
    monkeypatch.setattr(EF, "_sm_count", lambda index: H100_SMS)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    return lib


def _bf16_args(B=1, T1=4096, C1=8, bias=True, c3=C3):
    """bf16 inputs of one chunk (B T1 / 16 = 256 enc3 rows: the wgmma route's least)."""
    rng = np.random.RandomState(7)
    t = lambda *s: torch.from_numpy(rng.randn(*s)).bfloat16()
    return [t(B, C1, T1), t(C2, C1, 31), t(C2) if bias else None, t(C2), t(c3, C2, 31),
            t(c3) if bias else None, t(c3)]


def _counters():
    return EF.launches, EF.launches_tf32, EF.launches_tile16, EF.launches_wgmma


def test_launch_dispatches_the_wgmma_route(fake_lib):
    """A bf16 call at the kernel's widths reaches the wgmma entry with the permuted w2,
    the folded w3 and the shape, and counts in launches and launches_wgmma; force="mma"
    takes enc23_mma_kernel (dtype 1, padded weights) in the same call."""
    args = _bf16_args()
    h1, w2, b2, a2, w3, b3, a3 = args
    before = _counters()
    pre2, pre3, post3 = EF._launch(*args)
    name, call = fake_lib.calls[-1]
    assert name == "wgmma"
    assert call[:7] == (h1.data_ptr(), K._permuted_weights(w2).data_ptr(), b2.data_ptr(),
                        a2.data_ptr(), EF._folded_weights(w3).data_ptr(), b3.data_ptr(),
                        a3.data_ptr())
    assert call[7:10] == (pre2.data_ptr(), pre3.data_ptr(), post3.data_ptr())
    assert call[10:15] == (1, 8, 4096, C2, C3)
    assert _counters() == (before[0] + 1, before[1], before[2], before[3] + 1)
    EF._launch(*args, force="mma")
    name, call = fake_lib.calls[-1]
    assert name == "launch" and call[0] == 1
    assert call[2] == K._padded_weights(w2).data_ptr()
    assert _counters() == (before[0] + 2, before[1], before[2], before[3] + 1)
    narrow = _bf16_args(c3=128)  # not the kernel's widths: mma.sync, and forced raises
    EF._launch(*narrow)
    assert fake_lib.calls[-1][0] == "launch"
    with pytest.raises(ValueError, match="wgmma"):
        EF._launch(*narrow, force="wgmma")
    assert _counters() == (before[0] + 3, before[1], before[2], before[3] + 1)


@pytest.mark.parametrize("force,dtype", [("wgmma", torch.float32), ("fma", torch.bfloat16),
                                         ("tf32", torch.bfloat16), ("cudnn", torch.bfloat16)])
def test_force_names_a_route_of_the_dtype(fake_lib, force, dtype):
    args = [None if v is None else v.to(dtype) for v in _bf16_args()]
    before = _counters()
    with pytest.raises(ValueError, match="force"):
        EF._launch(*args, force=force)
    assert _counters() == before and not fake_lib.calls


def test_weights_are_permuted_and_folded_once_per_weight_and_version(fake_lib,
                                                                     monkeypatch):
    folds = []
    fold = EF._fold_w3
    monkeypatch.setattr(EF, "_fold_w3", lambda w: folds.append(w.shape) or fold(w))
    args = _bf16_args(bias=False)
    for _ in range(3):
        EF._launch(*args)
    assert folds == [(C3, C2, 31)]
    ptrs = {(call[1], call[4]) for _, call in fake_lib.calls}
    assert len(ptrs) == 1 and None in (fake_lib.calls[0][1][2], fake_lib.calls[0][1][5])
    with torch.no_grad():
        args[4].mul_(2)  # a new version of w3: folded anew
    EF._launch(*args)
    assert folds == [(C3, C2, 31)] * 2
    assert fake_lib.calls[-1][1][4] != fake_lib.calls[0][1][4]


def test_misaligned_h1_takes_mma_sync(fake_lib):
    """An h1 view that starts 2 bytes into its buffer is not what TMA reads: the rule
    keeps it on mma.sync, and forcing wgmma raises."""
    args = _bf16_args()
    buf = torch.cat([args[0].reshape(-1), args[0].new_zeros(1)])
    args[0] = buf[1:].view(args[0].shape)
    assert args[0].data_ptr() % 16 != 0 and args[0].is_contiguous()
    EF._launch(*args)
    assert fake_lib.calls[-1][0] == "launch"
    with pytest.raises(ValueError, match="aligned"):
        EF._launch(*args, force="wgmma")


@pytest.mark.parametrize("T1,want", [(1024, ("mma", 32)), (4096, ("wgmma", 64))])
def test_tool_reads_the_wgmma_route_from_the_counters(fake_lib, T1, want):
    args = _bf16_args(T1=T1, C1=2)  # enc3 rows: 64 and 256
    assert bench.route_taken(lambda: EF._launch(*args), torch.bfloat16) == want


def test_tool_kernel_x2_pads_into_pitched_rows(monkeypatch):
    """The A/B tool's per-layer arm pads as G's blocks do (``reflect_pad_pitched``), so on
    the card it takes G's routes: the x that each call receives lies in rows whose pitch
    is a multiple of 8, and its values are the reflect pad's."""
    seen = []
    layer = bench.fused_conv1d_prelu
    monkeypatch.setattr(bench, "fused_conv1d_prelu",
                        lambda x, *a: seen.append(x) or layer(x, *a))
    inputs = bench.make_inputs(2, t1=256, dtype=torch.float32)
    got = bench.kernel_x2(*inputs)
    assert len(seen) == 2
    for x, src in zip(seen, (inputs[0], None)):
        B, c, t_in = x.shape
        pitch = x.stride(1)
        assert t_in == (src.shape[2] if src is not None else 64) + 29
        assert x.stride() == (c * pitch, pitch, 1) and pitch % 8 == 0 and pitch > t_in
        assert K._pitch(x) == pitch
    torch.testing.assert_close(seen[0], conv_ops.reflect_pad_1d(inputs[0], 14, 15))
    for g, w in zip(got, EF.enc23_plain(*inputs)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_tool_device_arms_reach_the_entry_points(fake_lib, monkeypatch):
    """Without a card: the tool's device arms launch through the C entry points with the
    weights the wrappers make, the per-layer pair on G's routes from pitched rows (at one
    chunk enc2 on wgmma, enc3 on mma.sync with split-K), cuDNN's convs on the inputs."""
    layer_calls = []
    monkeypatch.setattr(K, "_wgmma_entry", lambda dtype=torch.bfloat16: (
        lambda *a: layer_calls.append(("wgmma", a)) or 0))
    monkeypatch.setattr(K, "_entries", lambda: tuple(
        (lambda *a, n=n: layer_calls.append((n, a)) or 0)
        for n in ("fma", "splits", "mma", "tf32")))
    monkeypatch.setattr(K, "_sm_count", lambda index: H100_SMS)
    args = _bf16_args(C1=64, bias=False)
    arms = bench.device_arms(*args)
    assert list(arms) == ["fused wgmma", "fused mma.sync", "kernel x2", "cuDNN x2"]
    arms["fused wgmma"]()
    arms["fused mma.sync"]()
    (n1, c1), (n2, c2) = fake_lib.calls
    assert n1 == "wgmma" and c1[1] == K._permuted_weights(args[1]).data_ptr()
    assert c1[4] == EF._folded_weights(args[4]).data_ptr() and c1[10:15] == (1, 64, 4096,
                                                                               C2, C3)
    assert n2 == "launch" and c2[0] == 1 and c2[2] == K._padded_weights(args[1]).data_ptr()
    arms["kernel x2"]()
    (r2, l2), (r3, l3) = layer_calls
    assert (r2, r3) == ("wgmma", "mma")
    assert l2[12] % 8 == 0 and l2[11] == 4096 + 29 and l2[1] == K._permuted_weights(
        args[1]).data_ptr()  # pitch, T_in
    assert l3[12] % 8 == 0 and l3[11] == 1024 + 29 and l3[6] is not None  # split-K
    assert [tuple(v.shape) for v in arms["cuDNN x2"]()] == [(1, C2, 1024), (1, C3, 256)]
