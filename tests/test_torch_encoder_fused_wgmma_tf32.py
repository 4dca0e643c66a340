"""The fp32 wgmma route of the port's chained enc2 + enc3 op
(segan_pytorch_tpu_torch/csrc/encoder_fused_wgmma_tf32.cu, ``enc23_wgmma_tf32_kernel<CL>``),
its route and cluster rules, its dispatch and the A/B tool's fp32 arms.

No card here: a float64 numpy emulation of exactly the kernel's maps is held against the
plain version in float64 and against the JAX Pallas kernel in interpret mode, at each
cluster size. It follows the kernel block by block: the cluster's ranks, each with C2 /
CL channels of post2 and enc3's depth over them; phase A's h1 boxes of 96 samples x CC
channels per m16 group, each starting XOFF = 2 samples before its window, TMA's zeros
outside [0, T1) and the reflect written into the landed boxes; h1 split into its TF32
parts at fragment load, w2's parts as the wrapper makes them, each channel's three
products summed into fresh sums, rounded to fp32 and added to the running sums in fp32;
post2 stored by slot through the kernel's address function into the folded tile of
padded pitch F, the mirror fill at T2, and read back by phase B's fragment address
function, split again; w3 folded and split by the wrapper, its columns by stage as the
producer loads them; the fresh-sum span of FOLD stages; the partial pre3 of the ranks
added in rank order in fp32. Products of TF32 parts are exact in float64, so what
differs from the exact chain is the split and the fp32 roundings the emulation makes;
the rounding of the tensor cores' own sums is the card's to show. Mutations of the
window offset, the pitch, the depth order and the rank's weight slice must fail. On the
card chip_smoke.py holds the kernel itself against the plain version and, at batch 300,
pre3 against float64.
"""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench
from test_torch_conv1d_tf32 import split
from test_torch_encoder_fused import _jax_fused, _jax_inputs, _to_port

SRC = build.CSRC_DIR / "encoder_fused_wgmma_tf32.cu"
ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132
# enc23_wgmma_tf32_kernel's constants, as in csrc/encoder_fused_wgmma_tf32.cu
(C2, C3, TILE, SLOTS, FROWS, A_GROUPS, WIN, XOFF, STEPS, DK, A_BOXES, A_PASSES) = (
    128, 256, 64, 284, 71, 20, 96, 2, 4, 16, 8, 3)
RED_LD = TILE + 4
# ring stages by cluster size CL
STAGES = {1: 2, 2: 4, 4: 4}
# max |emulation - exact chain| / max |exact|: 3xTF32 products (2^-22 of each) and fp32
# sums of up to 4096 terms; the card's limit, FP32_TOL, is 1e-4
TOL = 1e-5


def _na(cl):
    return C2 // cl


def _pitch(cl):
    """F: floats from one folded post2 row to the next, padded so that F % 32 == 4."""
    return 4 * _na(cl) + 4


def post2_index(p, cl_ch, cl, swap=False):
    """The float where slot p, block channel cl_ch of post2 lies in the block's folded
    tile (the kernel's phase-A store and mirror fill): folded row p / 4, depth
    (p % 4) NA + c; with `swap` the depth c 4 + p % 4 (a mutation)."""
    depth = cl_ch * 4 + p % 4 if swap else (p % 4) * _na(cl) + cl_ch
    return (p // 4) * _pitch(cl) + depth


def _prelu32(p, a):
    p = p.astype(np.float32)
    return (np.maximum(p, 0) + a.astype(np.float32) * np.minimum(p, 0)).astype(np.float32)


def _split64(v):
    return tuple(x.astype(np.float64) for x in split(v))


def _emulate(h1, w2, b2, a2, w3, b3, a3, cluster, xoff=XOFF, pitch_shift=0, swap=False,
             slice_shift=0):
    """What enc23_wgmma_tf32_kernel<cluster> computes, cluster by cluster and rank by
    rank, from float32 numpy inputs (port layout): (pre2, pre3, post3) in float64, NaN
    where no block stores. Mutations the comparisons must catch: `xoff` reads phase A's
    windows from that sample
    of their boxes, `pitch_shift` moves phase B's folded rows, `swap` stores post2 at
    depth c 4 + s, `slice_shift` gives a rank the weight columns of another's channels."""
    B, C1, T1 = h1.shape
    assert (w2.shape[0], w3.shape[0]) == (C2, C3)
    f32 = np.float32
    NA, F, CC = _na(cluster), _pitch(cluster), cluster
    chunks = NA // DK
    b_iters = 8 * 4 * chunks
    T2, T3 = T1 // 4, T1 // 16
    w2b, w2s = (v.numpy().astype(np.float64) for v in K._mma_weights(torch.from_numpy(w2)))
    w3b, w3s = (v.numpy().astype(np.float64)
                for v in EF._fold_split_w3(torch.from_numpy(w3)))  # (C3, 4096) each
    b2 = np.zeros(C2, f32) if b2 is None else b2
    b3 = np.zeros(C3, f32) if b3 is None else b3
    pre2 = np.full((B, C2, T2), np.nan)
    pre3, post3 = np.full((B, C3, T3), np.nan), np.full((B, C3, T3), np.nan)
    c1p = -(-C1 // CC) * CC  # whole stages of CC channels: TMA's zeros past C1
    rows_a = np.arange(16)[:, None] * 4 + np.arange(32)[None, :]  # row r, tap k of a group
    m = np.arange(TILE)[:, None]
    for b in range(B):
        h = np.zeros((c1p, T1), f32)
        h[:C1] = h1[b]
        for t0 in range(0, T3, TILE):
            t_end = min(t0 + TILE, T3)
            p0 = 4 * t0 - 14
            lo, hi = max(0, p0), min(T2 - 1, p0 + SLOTS - 1)
            x0 = 4 * p0 - 14 - XOFF  # group 0's box: XOFF samples before its window
            assert x0 % 4 == 0  # TMA starts a box on a 16-byte boundary
            boxes = np.zeros((A_GROUPS, c1p, WIN), f32)
            for q in range(A_GROUPS):
                start = x0 + 64 * q
                if start >= T1:  # not loaded: only rows the mirror fill overwrites read it
                    boxes[q] = np.nan
                    continue
                samp = start + np.arange(WIN)
                inside = (samp >= 0) & (samp < T1)
                boxes[q][:, inside] = h[:, samp[inside]]
                for i, s in enumerate(samp):  # the reflect written into the landed window
                    src = -s if -14 <= s < 0 else (2 * T1 - 2 - s if T1 <= s < T1 + 15
                                                   else None)
                    if src is not None and 0 <= src - start < WIN:
                        boxes[q][:, i] = boxes[q][:, src - start]
            # phase A's A: row 16 q + r, tap k at sample xoff + 4 r + k of group q's box
            A = boxes[:, :, xoff + rows_a].transpose(0, 2, 1, 3).reshape(A_GROUPS * 16, c1p,
                                                                         32)
            Ab, As = _split64(A)
            partials = []
            for rank in range(cluster):
                ch = slice(rank * NA, rank * NA + NA)
                acc = np.zeros((A_GROUPS * 16, NA), f32)
                for c in range(C1):  # a channel's 12 MMAs into fresh sums, then the fold
                    wb, ws = w2b[ch, c], w2s[ch, c]
                    part = As[:, c] @ wb.T + Ab[:, c] @ ws.T + Ab[:, c] @ wb.T
                    acc = (acc + part.astype(f32)).astype(f32)
                pre = (acc + b2[ch]).astype(f32)
                post = _prelu32(pre, a2[ch])
                flat = np.full(FROWS * F + 8, np.nan, f32)
                cl_ch = np.arange(NA)
                for p in range(SLOTS):
                    flat[post2_index(p, cl_ch, cluster, swap)] = post[p]
                    r = p0 + p
                    if 4 * t0 <= r < 4 * t_end:
                        pre2[b, ch, r] = pre[p]
                for p in range(SLOTS):  # the mirror fill
                    r = p0 + p
                    if lo <= r <= hi:
                        continue
                    src = -r if r < 0 else 2 * T2 - 2 - r
                    flat[post2_index(p, cl_ch, cluster, swap)] = (
                        flat[post2_index(src - p0, cl_ch, cluster, swap)] if lo <= src <= hi
                        else 0.0)
                # phase B: stage it's A from folded row m + q, its w3 columns by rank
                acc3 = np.zeros((TILE, C3), f32)
                d = np.arange(DK)[None, :]
                wr = (rank + slice_shift) % cluster
                for it in range(b_iters):
                    q, sp, chunk = it // (4 * chunks), (it // chunks) % 4, it % chunks
                    Av = flat[(m + q) * (F + pitch_shift) + sp * NA + DK * chunk + d]
                    Avb, Avs = _split64(Av)
                    cols = 512 * q + C2 * sp + wr * NA + DK * chunk + np.arange(DK)
                    wb, ws = w3b[:, cols], w3s[:, cols]
                    # a stage's 6 MMAs into fresh sums, then the fold
                    part3 = Avs @ wb.T + Avb @ ws.T + Avb @ wb.T
                    acc3 = (acc3 + part3.astype(f32)).astype(f32)
                partials.append(acc3)
            total = partials[0]
            for p_ in partials[1:]:  # the finishers add the ranks' slots in rank order
                total = (total + p_).astype(f32)
            p3 = (total + b3).astype(f32)[:t_end - t0]
            pre3[b, :, t0:t_end] = p3.T
            post3[b, :, t0:t_end] = _prelu32(p3, a3).T
    return pre2, pre3, post3


def _inputs(B, T1, C1, bias, seed=0):
    """float32 numpy inputs in the port's layout at the kernel's widths."""
    return [None if v is None else np.ascontiguousarray(v.numpy())
            for v in _to_port(*_jax_inputs(B, T1, C1, C2, C3, bias, seed))]


def _exact(args):
    t = lambda v: None if v is None else torch.from_numpy(v).double()
    return [v.numpy() for v in EF.enc23_plain(*map(t, args))]


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


CASES = {
    "T1=64 bias": (3, 64, 5, True, 4),         # one tile: both edges, most boxes past T1
    "T1=256": (2, 256, 8, False, 2),            # one tile of 16 rows, C1 a whole stage
    "ragged T1=1168 bias": (1, 1168, 6, True, 1),  # T3 = 73: a last tile of 9 rows
    "T1=4096": (1, 4096, 64, False, 2),         # SEGAN+ widths: 4 tiles, interior ones
}


@pytest.mark.parametrize("case", list(CASES))
def test_index_maps_match_plain(case):
    *shape, cluster = CASES[case]
    args = _inputs(*shape, seed=len(case))
    got = _emulate(*args, cluster)
    for g, w in zip(got, _exact(args)):
        assert g.shape == w.shape and not np.isnan(g).any()
        assert _rel(g, w) <= TOL, _rel(g, w)


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_every_cluster_size(cluster):
    """Each cluster's channel and depth slices and its reduction in rank order."""
    args = _inputs(2, 256, 3, True, seed=cluster)
    for g, w in zip(_emulate(*args, cluster), _exact(args)):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("cluster", [2, 4])
def test_emulation_matches_pallas_interpret(cluster):
    """The JAX kernel on the same float32 numbers, in interpret mode: 1e-5, two
    implementations summing in different orders in fp32 and float64."""
    inputs = _jax_inputs(2, 256, 8, C2, C3, True, seed=3)
    want = _jax_fused(*inputs)
    got = _emulate(*[None if v is None else v.numpy() for v in _to_port(*inputs)], cluster)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(0, 2, 1), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mutation", [dict(xoff=XOFF + 1), dict(xoff=XOFF - 1),
                                      dict(pitch_shift=-4), dict(swap=True),
                                      dict(slice_shift=1)],
                         ids=["window one sample on", "window one sample back",
                              "unpadded pitch", "s and c swapped", "another rank's w3"])
def test_a_wrong_map_fails(mutation):
    args = _inputs(1, 256, 4, False, seed=1)
    got = _emulate(*args, 2, **mutation)
    want = _exact(args)
    k = 0 if "xoff" in mutation else 1  # phase A's maps show in pre2, phase B's in pre3
    assert not _rel(got[k], want[k]) <= 1e-3


def test_padded_pitch_spreads_a_fragment_load_over_the_banks():
    """Lane (g, t) of a phase-B fragment load reads folded row g + const, depth t +
    const: with F % 32 == 4 the warp's 32 words fall in 32 distinct banks (8 rows x 4
    channels), at every cluster size; the unpadded pitch (4 NA) puts 8 lanes on a bank."""
    g, t = np.divmod(np.arange(32), 4)
    for cl in (1, 2, 4):
        assert len(set((g * _pitch(cl) + t) % 32)) == 32
        assert len(set((g * 4 * _na(cl) + t) % 32)) == 4


def test_emulated_constants_are_the_kernels():
    """Change the kernel's tile, boxes, ring, spans or post2 layout only together with
    its emulation."""
    src = SRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    names = ("C2", "C3", "TILE", "SLOTS", "FROWS", "A_GROUPS", "WIN", "XOFF", "STEPS", "DK",
             "A_BOXES", "A_PASSES")
    assert [int(consts[n]) for n in names] == [C2, C3, TILE, SLOTS, FROWS, A_GROUPS, WIN,
                                               XOFF, STEPS, DK, A_BOXES, A_PASSES]
    for line in ("constexpr int RED_LD = TILE + 4;",
                 "static constexpr int NA = C2 / CL;", "static constexpr int CC = CL;",
                 "static constexpr int F = 4 * NA + 4;",
                 "static constexpr int STAGES = CL == 1 ? 2 : 4;",
                 "static constexpr int CHUNKS = NA / DK;",
                 # the stores, the mirror fill and phase B's fragments: one address map
                 "post2 + (p / STRIDE) * P::F + (p % STRIDE) * P::NA + cl",
                 "arow + q * P::F + sp * P::NA + DK * (it % P::CHUNKS)",
                 "512 * q + C2 * sp + T.rank * P::NA + DK * (it % P::CHUNKS)",
                 "xs + c * WIN + XOFF + STRIDE * g + 8 * st + t",
                 "for (int r = 1; r < CL; ++r) sum += red[(r * P::SHARE + cl) * RED_LD + m];"):
        assert line in src, line
    assert (EF.WGMMA_C2, EF.WGMMA_C3, EF.WGMMA_TILE) == (C2, C3, TILE)
    assert EF.WGMMA_TF32_CLUSTERS == tuple(STAGES) and STAGES[4] == STAGES[2]
    for n in (128, 64, 32, 16):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32" in src
    for piece in ('#include "tma_ring.cuh"', '#include "mma_tf32.cuh"', "__grid_constant__",
                  "split_tf32", "CU_TENSOR_MAP_SWIZZLE_64B", "cudaLaunchKernelEx",
                  "cudaLaunchAttributeClusterDimension", "mapa.shared::cluster",
                  "st.shared::cluster", "barrier.cluster.arrive"):
        assert piece in src, piece
    ring = (build.CSRC_DIR / "tma_ring.cuh").read_text()
    assert "mbarrier.try_wait" not in src and "mbarrier.try_wait" in ring


def test_module_and_tool_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|segan_pytorch_tpu)\b(?!_torch)",
                     re.M)
    files = [ROOT / "segan_pytorch_tpu_torch/ops/kernels/encoder_fused.py",
             ROOT / "segan_pytorch_tpu_torch/tools/encoder_fused_bench.py"]
    assert not [f for f in files if pat.search(f.read_text())]
    assert "jax" not in SRC.read_text().lower()


@pytest.mark.parametrize("dtype,c2,c3,rows,aligned,route", [
    (torch.float32, 128, 256, 300 * 256, True, "wgmma_tf32"),    # SEGAN+ widths
    (torch.float32, 128, 256, EF.WGMMA_TF32_MIN_ROWS, True, "wgmma_tf32"),
    (torch.float32, 128, 256, EF.WGMMA_TF32_MIN_ROWS - 1, True, "tf32"),
    (torch.float32, 128, 256, 300 * 256, False, "tf32"),         # h1 off 16 bytes
    (torch.float32, 64, 256, 300 * 256, True, "tf32"),           # other widths
    (torch.float32, 128, 512, 300 * 256, True, "tf32"),
    (torch.float32, 24, 36, 300 * 256, True, "fma"),             # not whole n8 tiles
    (torch.bfloat16, 128, 256, 300 * 256, True, "wgmma"),        # bf16 as before
])
def test_route_rule(dtype, c2, c3, rows, aligned, route):
    assert EF._route(dtype, c2, c3, rows, aligned) == route


@pytest.mark.parametrize("B,cluster", [(1, 4), (2, 4), (4, 4), (5, 2), (8, 2), (16, 2),
                                       (17, 1), (32, 1), (64, 1), (300, 1)])
def test_cluster_rule_at_segan_widths(B, cluster):
    """At T1 = 4096 (4 tiles of 64 enc3 rows a batch row) on 132 SMs: 4 blocks a tile up
    to B = 4, 2 up to 16, then 1: the fastest cluster on the H100 at each batch timed."""
    assert EF._wgmma_tf32_cluster(B, 4096, H100_SMS) == cluster


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
    """The wrapper without a card: the three libraries replaced, an H100's SM count,
    CUDA's device and stream calls stubbed."""
    lib = _FakeLib()
    monkeypatch.setattr(EF, "_entries", lambda: (lib.entry("launch"), lib.entry("tf32")))
    monkeypatch.setattr(EF, "_wgmma_entry", lambda: lib.entry("wgmma"))
    monkeypatch.setattr(EF, "_wgmma_tf32_entry", lambda: lib.entry("wgmma_tf32"))
    monkeypatch.setattr(EF, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(K, "_sm_count", lambda index: H100_SMS)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    return lib


def _args(B=1, T1=4096, C1=8, bias=True, c3=C3):
    """fp32 inputs of one chunk (B T1 / 16 = 256 enc3 rows) at the kernel's widths."""
    rng = np.random.RandomState(11)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    return [t(B, C1, T1), t(C2, C1, 31), t(C2) if bias else None, t(C2), t(c3, C2, 31),
            t(c3) if bias else None, t(c3)]


def _counters():
    return (EF.launches, EF.launches_tf32, EF.launches_tile16, EF.launches_wgmma,
            EF.launches_wgmma_tf32)


def test_launch_dispatches_the_wgmma_tf32_route(fake_lib):
    """An fp32 call at the kernel's widths reaches the new entry with both parts of the
    padded w2, both parts of the folded w3, the rule's cluster and the shape, and counts
    in launches and launches_wgmma_tf32; cluster= sets the cluster; force="tf32" takes
    enc23_tf32_kernel and force="fma" the FMA kernel in the same call."""
    args = _args()
    h1, w2, b2, a2, w3, b3, a3 = args
    before = _counters()
    pre2, pre3, post3 = EF._launch(*args)
    name, call = fake_lib.calls[-1]
    (w2b, w2s), (w3b, w3s) = K._padded_weights(w2), EF._folded_weights(w3)
    assert name == "wgmma_tf32"
    assert call[:9] == (h1.data_ptr(), w2b.data_ptr(), w2s.data_ptr(), b2.data_ptr(),
                        a2.data_ptr(), w3b.data_ptr(), w3s.data_ptr(), b3.data_ptr(),
                        a3.data_ptr())
    assert call[9:12] == (pre2.data_ptr(), pre3.data_ptr(), post3.data_ptr())
    assert call[12:18] == (EF._wgmma_tf32_cluster(1, 4096, H100_SMS), 1, 8, 4096, C2, C3)
    assert _counters() == (before[0] + 1, before[1], before[2], before[3], before[4] + 1)
    EF._launch(*args, cluster=2)
    assert fake_lib.calls[-1][0] == "wgmma_tf32" and fake_lib.calls[-1][1][12] == 2
    EF._launch(*args, force="tf32")
    name, call = fake_lib.calls[-1]
    assert name == "tf32" and call[1:3] == (w2b.data_ptr(), w2s.data_ptr())
    assert call[12] == EF._tf32_tile(1, 4096, H100_SMS)
    EF._launch(*args, force="fma")
    name, call = fake_lib.calls[-1]
    assert name == "launch" and call[0] == 0 and call[2] == w2.data_ptr()
    assert _counters() == (before[0] + 4, before[1] + 1, before[2] + 1, before[3],
                           before[4] + 2)


@pytest.mark.parametrize("kwargs,dtype", [
    (dict(force="wgmma_tf32"), torch.bfloat16),   # the fp32 kernel's route
    (dict(force="wgmma"), torch.float32),         # the bf16 kernel's
    (dict(force="mma"), torch.float32),
    (dict(cluster=3), torch.float32),             # no such cluster
    (dict(cluster=2, force="tf32"), torch.float32),  # a cluster for the mma.sync kernel
    (dict(tile=16), torch.float32),               # a tile for the wgmma kernel
])
def test_launch_rejects_a_switch_off_its_route(fake_lib, kwargs, dtype):
    args = [None if v is None else v.to(dtype) for v in _args()]
    before = _counters()
    with pytest.raises(ValueError):
        EF._launch(*args, **kwargs)
    assert _counters() == before and not fake_lib.calls


def test_weights_are_split_and_folded_once_per_weight_and_version(fake_lib, monkeypatch):
    folds, pads = [], []
    fold, pad = EF._fold_w3, K._pad_taps
    monkeypatch.setattr(EF, "_fold_w3", lambda w: folds.append(w.shape) or fold(w))
    monkeypatch.setattr(K, "_pad_taps", lambda w: pads.append(w.shape) or pad(w))
    args = _args(bias=False)
    for _ in range(3):
        EF._launch(*args)
    assert folds == [(C3, C2, 31)] and pads == [(C2, 8, 31)]
    ptrs = {call[1:3] + call[5:7] for _, call in fake_lib.calls}
    assert len(ptrs) == 1 and fake_lib.calls[0][1][3] is None
    with torch.no_grad():
        args[4].mul_(2)  # a new version of w3: folded and split anew
    EF._launch(*args)
    assert folds == [(C3, C2, 31)] * 2 and pads == [(C2, 8, 31)]
    assert fake_lib.calls[-1][1][5] != fake_lib.calls[0][1][5]


def test_folded_parts_sum_to_the_fold():
    w3 = _args()[4]
    big, small = EF._fold_split_w3(w3)
    want = EF._fold_w3(w3)
    assert big.shape == small.shape == want.shape == (C3, 32 * C2)
    assert (big == K._tf32_round(want)).all()
    np.testing.assert_allclose((big.double() + small.double()).numpy(), want.double().numpy(),
                               rtol=2.0 ** -21, atol=0)


def test_misaligned_h1_keeps_mma_sync(fake_lib):
    """An h1 view 4 bytes into its buffer is not what TMA reads: the rule keeps it on
    enc23_tf32_kernel, and forcing the wgmma route raises."""
    args = _args()
    buf = torch.cat([args[0].reshape(-1), args[0].new_zeros(1)])
    args[0] = buf[1:].view(args[0].shape)
    assert args[0].data_ptr() % 16 != 0 and args[0].is_contiguous()
    EF._launch(*args)
    assert fake_lib.calls[-1][0] == "tf32"
    with pytest.raises(ValueError, match="aligned"):
        EF._launch(*args, force="wgmma_tf32")


@pytest.mark.parametrize("T1,want", [(1024, ("tf32", 16)), (4096, ("wgmma_tf32", 64))])
def test_tool_reads_the_route_from_the_counters(fake_lib, T1, want):
    args = _args(T1=T1, C1=2)  # enc3 rows: 64 and 256
    assert bench.route_taken(lambda: EF._launch(*args), torch.float32) == want


def test_tool_device_arms_reach_the_entry_points(fake_lib, monkeypatch):
    """Without a card: the tool's fp32 device arms launch through the C entry points with
    the weights the wrappers make: the wgmma kernel at the rule's cluster and at each
    asked for, enc23_tf32_kernel at the rule's tile, the per-layer pair on G's fp32
    routes from pitched rows, cuDNN's convs on the inputs."""
    layer_calls = []
    monkeypatch.setattr(K, "_wgmma_entry", lambda dtype=torch.bfloat16: (
        lambda *a: layer_calls.append(("wgmma", dtype, a)) or 0))
    monkeypatch.setattr(K, "_entries", lambda: tuple(
        (lambda *a, n=n: layer_calls.append((n, None, a)) or 0)
        for n in ("fma", "splits", "mma", "tf32")))
    args = _args(C1=64, bias=False)
    arms = bench.device_arms(*args, clusters=(1, 4))
    assert list(arms) == ["fused wgmma_tf32", "fused wgmma_tf32 CL1", "fused wgmma_tf32 CL4",
                          "fused tf32", "kernel x2", "cuDNN x2"]
    for name in ("fused wgmma_tf32", "fused wgmma_tf32 CL1", "fused wgmma_tf32 CL4",
                 "fused tf32"):
        arms[name]()
    (n1, c1), (n2, c2), (n3, c3), (n4, c4) = fake_lib.calls
    w3b, w3s = EF._folded_weights(args[4])
    assert (n1, n2, n3, n4) == ("wgmma_tf32",) * 3 + ("tf32",)
    assert c1[5:7] == (w3b.data_ptr(), w3s.data_ptr())
    assert [c[12] for c in (c1, c2, c3)] == [EF._wgmma_tf32_cluster(1, 4096, H100_SMS), 1, 4]
    assert c4[12] == EF._tf32_tile(1, 4096, H100_SMS) and c4[1] == K._padded_weights(
        args[1])[0].data_ptr()
    arms["kernel x2"]()
    (r2, d2, l2), (r3, d3, l3) = layer_calls
    # each layer on the fp32 route G takes: wgmma or mma.sync, by 3xTF32
    names = {"wgmma": "wgmma", "mma": "tf32"}
    assert r2 == names[K._route(torch.float32, 1, 64, C2, 31, 4, 1024, True)]
    assert r3 == names[K._route(torch.float32, 1, C2, C3, 31, 4, 256, True)]
    assert d2 in (None, torch.float32) and d3 in (None, torch.float32)
    assert l2[1:3] == tuple(v.data_ptr() for v in K._padded_weights(args[1]))
    assert l2[13] % 8 == 0 and l2[12] == 4096 + 29  # pitch, T_in
    assert l3[13] % 8 == 0 and l3[12] == 1024 + 29
    assert [tuple(v.shape) for v in arms["cuDNN x2"]()] == [(1, C2, 1024), (1, C3, 256)]
