"""The rows route of the port's fused conv + bias + PReLU (segan_pytorch_tpu_torch/csrc/
conv1d_rows.cu, ``conv1d_rows_kernel``): its plan and place in the route rule, the launch
record that every route's calls keep, and ``conv1d_prelu``'s direct call where autograd
records nothing.

No card here: a float64 numpy emulation of exactly the kernel's index maps (swap-AB, the
output channels on the MMA's 64 rows and B T_out rows on its width, rounded up to n with
the rows past the live ones never stored; rows n -> (b, t) across batch rows; x staged
once per block as the rows' windows end to end, four samples a row and 28 more a batch
row, zero at or past T_in; the B tile built from them through the 128-byte swizzle and
read back as the descriptor reads it; the weights' taps in their order, a ring stage of
two input channels, zero past Cin; the input channels cut into the cluster's slices; the
partial sums added in rank order, each block finishing 64 / cluster channels) is held
against the plain version and against the JAX kernel, in interpret mode where its T_out
is a multiple of 8 and through the JAX package's own conv elsewhere. Its mutations (a
window one sample off, a slice boundary one channel off) must fail. On the card
chip_smoke.py holds the kernel itself against the plain version.
"""
import gc
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from segan_pytorch_tpu.ops.conv import conv1d as jax_conv1d
from segan_pytorch_tpu.ops.pallas import conv1d as plconv
from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

# conv1d_rows_kernel's constants, as in csrc/conv1d_rows.cu
BM, STAGES, SEG_SLACK, MAX_SMEM, CHANNEL_ALIGN = 64, 8, 40, 232448, 8
H100_SMS = 132
T, KW = 16384, 31
CHANS = [1, 64, 128, 256, 512, 1024]


def _segment(j, r0, n_live, t_out, b_first):
    """(b, s0, len, base) of batch row b_first + j of a tile (the kernel's ``Segment``):
    its samples s0 .. s0 + len - 1 staged at `base` of each channel's windows."""
    b = b_first + j
    t_first = r0 - b * t_out if j == 0 else 0
    t_last = min(t_out - 1, r0 + n_live - 1 - b * t_out)
    s0 = 4 * t_first // 8 * 8
    length = (4 * t_last + 32 - s0 + 7) // 8 * 8
    if j == 0:
        return b, s0, length, 0
    t0 = r0 - b_first * t_out
    first = (4 * min(t_out - 1, r0 + n_live - 1 - b_first * t_out) + 32 - 4 * t0 // 8 * 8
             + 7) // 8 * 8
    return b, s0, length, first + (j - 1) * ((4 * (t_out - 1) + 32 + 7) // 8 * 8)


def _emulate_rows_kernel(x_buf, t_in, w, b, a, plan, shift=0, slice_off=0, swizzle=True):
    """What conv1d_rows_kernel computes, in float64 numpy: (y, pre) (B, Cout, T_out),
    NaN where no block stores. x_buf is x's buffer (B, Cin, pitch), of which samples <
    t_in are read; w (Cout, Cin, K); plan (n, rows_per_tile, cluster). `shift` moves every
    staged window by that many samples and `slice_off` every block's first input channel
    by that many (mutations the comparisons must catch). `swizzle` False reads the weight
    tiles straight, skipping the (identity) round trip through the 128-byte swizzle."""
    B, cin, pitch = x_buf.shape
    cout, _, k = w.shape
    t_out = (t_in - k) // 4 + 1
    n, per, cluster = plan
    assert cout % BM == 0 and cin > 1 and per <= n and BM % cluster == 0 and cluster <= 8
    M = B * t_out
    tiles = -(-M // per)
    slice_ = -(-(-(-cin // cluster)) // 2) * 2
    nseg_max = min(B, (per + t_out - 2) // t_out + 1)
    lr = -(-(4 * per + SEG_SLACK * nseg_max) // 8) * 8
    wt = K._rows_tiles(torch.from_numpy(w)).numpy()  # (Cout / 64, Cin8 / 2, 64, 64)
    # each tile as TMA leaves it in shared memory: 16-byte chunk q of row r at q ^ (r % 8)
    rr, qq, ee = np.arange(64)[:, None, None], np.arange(8)[None, :, None], np.arange(8)
    swz = (rr * 64 + ((qq ^ (rr % 8)) * 8) + ee).reshape(64, 64)
    if swizzle:
        smem_tiles = np.empty((*wt.shape[:2], 64 * 64))
        smem_tiles[..., swz.ravel()] = wt.reshape(*wt.shape[:2], 64 * 64)
    else:
        smem_tiles = wt.reshape(*wt.shape[:2], 64 * 64)
    # what ldmatrix gives at step kk: rows 0..63 (warp w's 16 w ..), taps 16 kk ..
    # 16 kk + 15 of the tile, read through the same swizzle
    col = 16 * np.arange(4)[:, None, None] + np.arange(16)[None, None, :]
    r64 = rr[:, :, 0][None]
    a_at = (r64 * 64 + ((col // 8) ^ (r64 % 8)) * 8 + col % 8 if swizzle
            else r64 * 64 + col)
    y = np.full((B, cout, t_out), np.nan)
    pre = np.full((B, cout, t_out), np.nan)
    g, t = np.arange(8)[:, None], np.arange(4)[None, :]
    for z in range(tiles):
        r0 = z * per
        n_live = min(per, M - r0)
        b_first = r0 // t_out
        nseg = (r0 + n_live - 1) // t_out - b_first + 1
        assert nseg <= nseg_max
        segs = [_segment(j, r0, n_live, t_out, b_first) for j in range(nseg)]
        assert segs[-1][3] + segs[-1][2] <= lr
        rows = r0 + np.arange(n_live)
        bs, ts = rows // t_out, rows % t_out
        rowoff = np.zeros(n, np.int64)  # rows past the live ones read row 0's window
        for i in range(n_live):
            _, s0, _, base = segs[bs[i] - b_first]
            rowoff[i] = base + 4 * ts[i] - s0
        red = []
        for rank in range(cluster):
            c_begin = rank * slice_ + slice_off
            nch = max(0, min(cin, c_begin + slice_) - c_begin)
            # x's windows: NaN where nothing is staged, so that a read of one shows
            raw = np.full((slice_, lr), np.nan)
            for c in range(nch):
                for bb, s0, length, base in segs:
                    s = s0 + shift + np.arange(length)
                    raw[c, base:base + length] = np.where(
                        s < t_in, x_buf[bb, c_begin + c, np.minimum(s, t_in - 1)], 0.0)
            d = np.zeros((cout, n))
            for kx in range(-(-nch // 2)):  # ring stages: the pair c_begin / 2 + kx
                for kk in range(4):
                    c = 2 * kx + kk // 2
                    if c >= nch:
                        continue
                    a_k = smem_tiles[:, c_begin // 2 + kx][:, a_at[kk]].reshape(cout, 16)
                    # B from the windows, lane by lane: rows 8 j + g, taps 2 t, 2 t + 1
                    # (b0) and 2 t + 8, 2 t + 9 (b1) of channel c from 16 (kk % 2)
                    b_k = np.full((16, n), np.nan)
                    for j in range(n // 8):
                        at = c * lr + rowoff[8 * j + g] + 16 * (kk % 2) + 2 * t  # (8, 4)
                        flat = raw.ravel()
                        for e in range(2):
                            b_k[2 * t + e, 8 * j + g] = flat[at + e]
                            b_k[2 * t + 8 + e, 8 * j + g] = flat[at + 8 + e]
                    d += a_k @ b_k
            red.append(d)
        # block `rank` of each m64 tile finishes its 64 / cluster channels: the blocks'
        # sums in rank order, the bias, the PReLU; the live rows alone
        share = BM // cluster
        for rank in range(cluster):
            cos = np.array([m0 + rank * share + j for m0 in range(0, cout, BM)
                            for j in range(share)])
            s = red[0][cos, :n_live].copy()
            for q in range(1, cluster):
                s = s + red[q][cos, :n_live]
            p = s + (b[cos, None] if b is not None else 0.0)
            pre[bs[None, :], cos[:, None], ts[None, :]] = p
            y[bs[None, :], cos[:, None], ts[None, :]] = (np.maximum(p, 0)
                                                         + a[cos, None] * np.minimum(p, 0))
    return y, pre


def _case(B, cin, cout, t_out, bias, seed, pitched=True, k=KW):
    """x (a buffer of rows `pitch` apart, T_in = 4 (T_out - 1) + 32 read: the zero tap reads
    sample T_in, which must read 0), w, b, a in float64."""
    rng = np.random.RandomState(seed)
    t_in = 4 * (t_out - 1) + k + 1
    pitch = -(-t_in // 8) * 8 + 8 if pitched else t_in
    x_buf = rng.randn(B, cin, pitch)
    x_buf[..., t_in:] = np.nan  # past T_in: never read
    w = rng.randn(cout, cin, k) / np.sqrt(cin * k)
    b = rng.randn(cout) * 0.1 if bias else None
    a = rng.uniform(0, 0.3, cout)
    return x_buf, t_in, w, b, a


def _plain(x_buf, t_in, w, b, a):
    x = torch.from_numpy(np.ascontiguousarray(x_buf[..., :t_in]))
    y, pre = K.conv1d_prelu_plain(x, torch.from_numpy(w),
                                  None if b is None else torch.from_numpy(b),
                                  torch.from_numpy(a), 4)
    return y.numpy(), pre.numpy()


def _err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# (B, Cin, Cout, T_out, bias): T_out 2, 4, 8, 16, 33, 132 at narrow widths, rows across
# batch rows (B T_out up to 264: two row tiles), both MMA widths' edges
NARROW = [(1, 8, 64, 2, False), (3, 6, 64, 2, True), (8, 16, 128, 4, False),
          (5, 12, 64, 4, True), (2, 10, 64, 8, True), (1, 4, 64, 16, False),
          (7, 8, 64, 16, True), (1, 18, 64, 33, True), (4, 8, 64, 33, False),
          (1, 6, 64, 132, True), (2, 4, 64, 132, False)]


@pytest.mark.parametrize("B,cin,cout,t_out,bias", NARROW)
def test_emulation_matches_plain(B, cin, cout, t_out, bias):
    x_buf, t_in, w, b, a = _case(B, cin, cout, t_out, bias, seed=B * 100 + t_out)
    plan = K._rows_plan(B, cin, cout, t_out, H100_SMS)
    y, pre = _emulate_rows_kernel(x_buf, t_in, w, b, a, plan)
    y_ref, pre_ref = _plain(x_buf, t_in, w, b, a)
    assert not np.isnan(pre).any() and not np.isnan(y).any()
    assert _err(pre, pre_ref) < 1e-12 and _err(y, y_ref) < 1e-12


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_every_cluster_size(cluster):
    """Each cluster's slices (32 channels in 1-8 slices) and its reduction (64 / cluster
    channels a block), two m64 tiles, odd B across batch rows, contiguous odd rows."""
    x_buf, t_in, w, b, a = _case(3, 32, 128, 12, True, seed=cluster, pitched=False)
    y, pre = _emulate_rows_kernel(x_buf, t_in, w, b, a, (64, 36, cluster))
    y_ref, pre_ref = _plain(x_buf, t_in, w, b, a)
    assert _err(pre, pre_ref) < 1e-12 and _err(y, y_ref) < 1e-12


def test_odd_cin_and_short_taps():
    """Cin odd (the last stage's second channel lies past Cin: zero weights, zero x) and
    K < 31 (the padded taps zero)."""
    x_buf, t_in, w, b, a = _case(2, 7, 64, 9, True, seed=7, k=17)
    plan = K._rows_plan(2, 7, 64, 9, H100_SMS)
    y, pre = _emulate_rows_kernel(x_buf, t_in, w, b, a, plan)
    y_ref, pre_ref = _plain(x_buf, t_in, w, b, a)
    assert _err(pre, pre_ref) < 1e-12 and _err(y, y_ref) < 1e-12


def test_enc5_at_full_width_one_chunk():
    """G's deepest layer at one chunk of 16384 samples: 512 -> 1024 channels, 16 rows, on
    its plan (n 16, 8 slices: 16 x 8 = 128 blocks)."""
    x_buf, t_in, w, b, a = _case(1, 512, 1024, 16, False, seed=11)
    plan = K._rows_plan(1, 512, 1024, 16, H100_SMS)
    assert plan == (16, 16, 8)
    y, pre = _emulate_rows_kernel(x_buf, t_in, w, b, a, plan, swizzle=False)
    y_ref, pre_ref = _plain(x_buf, t_in, w, b, a)
    assert _err(pre, pre_ref) < 1e-12 and _err(y, y_ref) < 1e-12


@pytest.mark.parametrize("mutation", [dict(shift=1), dict(slice_off=1)],
                         ids=["window one sample off", "slice boundary one channel off"])
def test_mutations_fail(mutation):
    x_buf, t_in, w, b, a = _case(2, 16, 64, 33, True, seed=3)
    plan = K._rows_plan(2, 16, 64, 33, H100_SMS)
    assert plan[2] > 1
    _, pre = _emulate_rows_kernel(x_buf, t_in, w, b, a, plan, **mutation)
    _, pre_ref = _plain(x_buf, t_in, w, b, a)
    assert not _err(np.nan_to_num(pre, nan=1e9), pre_ref) < 1e-3


@pytest.mark.parametrize("t_out,bias", [(8, True), (16, False), (33, True), (2, False)])
def test_emulation_matches_jax(t_out, bias):
    """The JAX kernel (interpret mode) on its own layout, x (B, T, C), w (K, Cin, Cout),
    where it takes T_out (a multiple of 8); the JAX package's conv + PReLU, its plain
    reference, at the other T_out."""
    rng = np.random.RandomState(t_out)
    B, cin, cout = 2, 6, 64
    t_in = 4 * (t_out - 1) + KW
    x = rng.randn(B, t_in, cin).astype(np.float32)
    w = (rng.randn(KW, cin, cout) / np.sqrt(KW * cin)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    a = rng.uniform(0, 0.3, cout).astype(np.float32)
    bj = jnp.asarray(b if bias else np.zeros_like(b))
    if t_out % 8 == 0:
        y_j, pre_j = plconv.fused_conv1d_prelu(jnp.asarray(x), jnp.asarray(w), bj,
                                               jnp.asarray(a), 4, 256, True)
    else:
        pre_j = jax_conv1d(jnp.asarray(x), jnp.asarray(w), bj, stride=4)
        y_j = jnp.maximum(pre_j, 0) + jnp.asarray(a) * jnp.minimum(pre_j, 0)
    x_buf = np.concatenate([x.transpose(0, 2, 1), np.full((B, cin, 5), np.nan)], axis=-1)
    y, pre = _emulate_rows_kernel(x_buf.astype(np.float64), t_in,
                                  w.transpose(2, 1, 0).astype(np.float64),
                                  b.astype(np.float64) if bias else None,
                                  a.astype(np.float64), K._rows_plan(B, cin, cout, t_out,
                                                                    H100_SMS))
    np.testing.assert_allclose(pre.transpose(0, 2, 1), np.asarray(pre_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.transpose(0, 2, 1), np.asarray(y_j), rtol=1e-5, atol=1e-5)


def test_emulated_constants_are_the_kernels():
    """Change the kernel's tile, ring, windows or shared memory only together with its
    emulation and the wrapper's mirror of them."""
    src = (build.CSRC_DIR / "conv1d_rows.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert [int(consts[n]) for n in ("BM", "STAGES", "SEG_SLACK", "MAX_SMEM", "MAX_CLUSTER",
                                     "CHANNEL_ALIGN")] == [
        BM, STAGES, SEG_SLACK, MAX_SMEM, 8, CHANNEL_ALIGN]
    assert (K.ROWS_BM, K.ROWS_STAGES, K.ROWS_SEG_SLACK, K.ROWS_MAX_SMEM,
            K.ROWS_CHANNEL_ALIGN) == (BM, STAGES, SEG_SLACK, MAX_SMEM, CHANNEL_ALIGN)
    assert K.ROWS_CLUSTERS == (1, 2, 4, 8)
    for n in K.ROWS_N:  # every width the wrapper plans is instantiated
        assert f"ROWS_CASE({n})" in src
    for piece in ("mma.sync.aligned.m16n8k16", "ldmatrix.sync.aligned.m8n8.x4",
                  "cp.async.bulk.shared::cluster.global", "cudaLaunchKernelEx",
                  "cudaLaunchAttributeClusterDimension", "mapa.shared::cluster",
                  "st.shared::cluster", "barrier.cluster.arrive",
                  '#include "tma_ring.cuh"', '#include "mma_bf16.cuh"', "__grid_constant__"):
        assert piece in src + (build.CSRC_DIR / "mma_bf16.cuh").read_text(), piece
    # the launch entry encodes no tensor map: the map comes from conv1d_rows_encode
    launch = src[src.index('extern "C" int conv1d_rows_launch'):]
    assert "encode" not in launch and "cuTensorMapEncode" not in src


def test_rows_smem_mirrors_the_kernels_layout():
    """``_rows_smem`` is csrc/conv1d_rows.cu's Layout: the ring, the partial sums, x's
    windows, the rows' offsets (8-byte aligned), the bias and slope, the batch rows'
    places, the barriers."""
    ring = STAGES * BM * 64 * 2
    for n, per, cluster, B, cin, t_out in [(16, 16, 8, 1, 512, 16), (256, 256, 8, 1, 128, 256),
                                           (64, 33, 4, 3, 40, 11), (8, 2, 8, 1, 512, 2)]:
        per_c = -(-(-(-cin // cluster)) // 2) * 2
        nseg = min(B, (per + t_out - 2) // t_out + 1)
        lr = -(-(4 * per + SEG_SLACK * nseg) // 8) * 8
        raw = ring + BM * (n + 4) * 4
        outbase = -(-(raw + per_c * lr * 2 + 4 * n) // 8) * 8
        assert K._rows_smem(n, per, cluster, B, cin, t_out) == (
            1024 + outbase + 8 * n + 2 * BM * 4 + 20 * n + (2 * STAGES + 1) * 8)


def test_rows_tiles_are_the_maps_rows():
    """The weight copy in m64-tile order: tile (m, p) is output channels 64 m .. 64 m + 63
    by the 32 padded taps of input channels 2 p and 2 p + 1, channels past Cin zero."""
    w = torch.randn(128, 5, 31)
    wt = K._rows_tiles(w)
    assert wt.shape == (2, 4, 64, 64) and wt.is_contiguous()
    wp = K._pad_taps(w)
    for m in range(2):
        for p in range(4):
            for h in range(2):
                c = 2 * p + h
                want = wp[64 * m:64 * m + 64, c] if c < 5 else torch.zeros(64, 32)
                assert torch.equal(wt[m, p, :, 32 * h:32 * h + 32], want)


def test_rows_plans_at_the_main_path_shapes():
    """The plans of serving's layers: tiles of at most 64 rows, halved while fewer than
    ROWS_BLOCKS blocks at the cluster of 8; the largest cluster within ROWS_BLOCKS."""
    assert (K.ROWS_TILE_ROWS, K.ROWS_BLOCKS) == (64, 128)
    want = {(1, 512, 1024, 16): (16, 16, 8), (1, 256, 512, 64): (32, 32, 8),
            (1, 128, 256, 256): (64, 64, 8), (1, 64, 128, 128): (16, 16, 8),
            (1, 128, 256, 32): (8, 8, 8), (1, 256, 512, 8): (8, 8, 8),
            (1, 512, 1024, 2): (8, 2, 8), (1, 64, 128, 256): (32, 32, 8),
            (8, 512, 1024, 4): (32, 32, 8), (1, 256, 512, 132): (64, 44, 4),
            (1, 512, 1024, 33): (64, 33, 8)}
    for (B, cin, cout, t_out), plan in want.items():
        assert K._rows_plan(B, cin, cout, t_out, H100_SMS) == plan, (B, cin, cout, t_out)
        n, per, cluster = plan
        assert K._rows_smem(n, per, cluster, B, cin, t_out) <= MAX_SMEM
        assert cout // BM * -(-B * t_out // per) * cluster <= K.ROWS_BLOCKS
    # forced at more rows: tiles of at most 64 rows
    assert K._rows_plan(1, 128, 256, 528, H100_SMS)[:2] == (64, 59)
    assert K._rows_plan(64, 128, 256, 256, H100_SMS)[:2] == (64, 64)


def _g_routes(B, t, bias=False):
    """_route's picks for the five layers of one bf16 G forward of B rows of t samples, x
    in G's pitched rows."""
    routes = []
    for i in range(5):
        t //= 4
        routes.append(K._route(torch.bfloat16, B, CHANS[i], CHANS[i + 1], KW, 4, t, True))
    return "/".join(routes)


def test_route_pins_at_serving_shapes():
    """The rule at phase 8a's served G forwards (chip_smoke.py: passes of 1-128 chunks,
    windows of 2048 and 4096 at 1-8 rows, WSEGAN's padded lengths): the rows route where
    B T_out <= ROWS_MAX_ROWS with one batch row or a T_out % 16 != 0 (a window's enc4-5 at
    any rows), enc1 on FMAs below its rows."""
    assert K.ROWS_MAX_ROWS == 256
    want = {(1, 2048): "fma/rows/rows/rows/rows", (2, 2048): "fma/mma/mma/rows/rows",
            (4, 2048): "fma/mma/mma/rows/rows", (8, 2048): "fma/wgmma/mma/rows/rows",
            (1, 4096): "fma/rows/rows/rows/rows", (2, 4096): "fma/mma/mma/mma/rows",
            (4, 4096): "fma/wgmma/mma/mma/rows", (8, 4096): "fma/wgmma/mma/mma/rows",
            (1, 16384): "fma/wgmma/rows/rows/rows", (2, 16384): "fma/wgmma/mma/mma/mma",
            (3, 16384): "fma/wgmma/mma/mma/mma", (4, 16384): "fma/wgmma/wgmma/mma/mma",
            (9, 16384): "fma/wgmma/wgmma/mma/mma", (16, 16384): "fma/wgmma/wgmma/wgmma/mma",
            (29, 16384): "fma/wgmma/wgmma/wgmma/mma",
            (32, 16384): "mma/wgmma/wgmma/wgmma/wgmma",
            (128, 16384): "mma/wgmma/wgmma/wgmma/wgmma",
            (1, 5120): "fma/mma/rows/rows/rows", (1, 20480): "fma/wgmma/mma/rows/rows",
            (1, 33792): "fma/wgmma/mma/rows/rows"}
    for (B, t), routes in want.items():
        assert _g_routes(B, t) == routes, (B, t)
    # fp32 keeps its routes; stride 2 and Cin = 1 never take rows
    assert "rows" not in K._route(torch.float32, 1, 512, 1024, KW, 4, 16, True)
    assert K._route(torch.bfloat16, 1, 512, 1024, KW, 2, 16, True) != "rows"
    assert K._route(torch.bfloat16, 1, 1, 64, KW, 4, 16, True) == "fma"
    assert K._route(torch.bfloat16, 1, 64, 96, KW, 4, 16, True) == "mma"  # Cout % 64


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
    monkeypatch.setattr(K, "_wgmma_entry", lambda dtype=torch.bfloat16: lib.entry("wgmma"))
    monkeypatch.setattr(K, "_rows_entries", lambda: (lib.entry("rows_encode"),
                                                      lib.entry("rows")))
    monkeypatch.setattr(K, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(K, "_records", {})
    monkeypatch.setattr(K, "_current_device", lambda: None)  # x's index on the CPU
    monkeypatch.setattr(K, "_current_stream", lambda index: 7)
    return lib


def _layer(B=1, cin=512, cout=1024, t_out=16, pitch_pad=3, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    t_in = 4 * t_out + 29
    buf = torch.randn(B, cin, t_in + pitch_pad, generator=g).to(dtype)
    x = buf[..., :t_in]
    w = torch.randn(cout, cin, KW, generator=g).to(dtype)
    a = torch.rand(cout, generator=g).to(dtype)
    return x, w, a, t_out


def test_launch_dispatches_the_rows_route(fake_lib):
    """A few-row bf16 call reaches the rows entry with the weights' tensor map (encoded
    once, when the copy is made), its plan, x's pitch and the stream, and counts in
    launches, launches_mma and launches_rows; force="mma" takes mma.sync on the same x."""
    x, w, a, t_out = _layer()
    before = (K.launches, K.launches_mma, K.launches_tf32, K.launches_wgmma,
              K.launches_rows)
    K._launch(x, w, None, a, 4, t_out)
    K._launch(x, w, None, a, 4)
    names = [n for n, _ in fake_lib.calls]
    assert names == ["rows_encode", "rows", "rows"]  # one map for the weight copy
    wp, _, addr = K._rows_weights(w)
    assert fake_lib.calls[0][1][1:] == (wp.data_ptr(), 1024, 512)
    assert torch.equal(wp, K._rows_tiles(w))
    args = fake_lib.calls[1][1]
    assert args[:2] == (x.data_ptr(), addr) and args[2] is None
    assert args[6:9] == K._rows_plan(1, 512, 1024, t_out, H100_SMS)
    assert args[9:] == (1, 512, x.shape[2], x.stride(1), 1024, t_out, 7)
    assert (K.launches, K.launches_mma, K.launches_tf32, K.launches_wgmma,
            K.launches_rows) == (before[0] + 2, before[1] + 2, before[2], before[3],
                                 before[4] + 2)
    K._launch(x, w, None, a, 4, t_out, force="mma")
    assert fake_lib.calls[-1][0] == "mma" and K.launches_rows == before[4] + 2
    with pytest.raises(ValueError, match="T_out"):
        K._launch(x, w, None, a, 4, t_out + 1)


def test_a_record_per_signature(fake_lib):
    """One record per call signature: a new pitch, alignment, shape or dtype makes its
    own, with its own plan and arguments; the same signature again makes none."""
    x, w, a, t_out = _layer(cin=64, cout=128)
    K._launch(x, w, None, a, 4)
    K._launch(_layer(cin=64, cout=128, seed=1)[0], w, None, a, 4)  # other values, the same signature
    assert len(K._records) == 1
    K._launch(x.contiguous(), w, None, a, 4)  # a new pitch
    assert fake_lib.calls[-1][1][12] == x.shape[2] and len(K._records) == 2
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    odd = buf[1:].view(x.shape).copy_(x)  # 2 bytes off 16-byte alignment
    K._launch(odd, w, None, a, 4)
    assert len(K._records) == 3 and fake_lib.calls[-1][1][0] == odd.data_ptr()
    x2, w2, a2, t2 = _layer(B=2, cin=64, cout=128, t_out=33)  # a new shape: ragged T_out, two batch rows
    K._launch(x2, w2, None, a2, 4)
    assert fake_lib.calls[-1][1][6:9] == K._rows_plan(2, 64, 128, 33, H100_SMS)
    assert len(K._records) == 4
    x3, w3, a3, _ = _layer(cin=64, cout=128, dtype=torch.float32)  # fp32: the 3xTF32 mma.sync route
    K._launch(x3, w3, None, a3, 4)
    assert fake_lib.calls[-1][0] == "tf32" and len(K._records) == 5


def test_a_weight_changed_in_place_is_seen(fake_lib):
    """The record keeps no weights: an optimizer step in place (a version bump) makes a
    new copy and map on the next call."""
    x, w, a, t_out = _layer(cin=64, cout=128, t_out=32)
    w = torch.nn.Parameter(w)
    with torch.no_grad():
        K._launch(x, w, None, a, 4)
        first = fake_lib.calls[-1][1][1]
        K._launch(x, w, None, a, 4)
        assert fake_lib.calls[-1][1][1] == first
        w.mul_(2)
        K._launch(x, w, None, a, 4)
    assert [n for n, _ in fake_lib.calls].count("rows_encode") == 2
    wp, _, addr = K._rows_weights(w)
    assert fake_lib.calls[-1][1][1] == addr and torch.equal(wp, K._rows_tiles(w))
    gc.collect()
    n = len(K._rows)
    del w, wp
    gc.collect()
    assert len(K._rows) == n - 1  # an entry lives as long as its weight


def test_refused_inputs_still_raise(fake_lib):
    """A record made by a good call lets no input through that the checks refuse: each
    raises what it raised before, and launches nothing."""
    x, w, a, t_out = _layer(B=3, cin=64, cout=128, t_out=32)
    K._launch(x, w, None, a, 4)
    n = (K.launches, len(fake_lib.calls))
    bad = [
        (TypeError, (x, w.float(), None, a, 4)),            # w's dtype
        (TypeError, (x, w, None, a.float(), 4)),            # a's dtype
        (ValueError, (x, w, torch.zeros(3).bfloat16(), a, 4)),  # b's shape
        (ValueError, (x, w[:, :32], None, a, 4)),           # Cin
        (ValueError, (x, w, None, a[:64], 4)),              # a's shape
        (ValueError, (x, w, None, a, 4.0)),                 # a stride that is not an int
        (ValueError, (x, w, None, a, 0)),
        (ValueError, (x[..., :20], w, None, a, 4)),         # shorter than the kernel
        (ValueError, (x.transpose(0, 1).contiguous().transpose(0, 1), w, None, a, 4)),
        (ValueError, (x[::2], w, None, a, 4)),              # every other batch row
        (ValueError, (x, w.transpose(0, 1).contiguous().transpose(0, 1), None, a, 4)),
        (TypeError, (x.half(), w.half(), None, a.half(), 4)),  # fp16: no kernel
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            K._launch(*args)
    with pytest.raises(ValueError, match="route"):
        K._launch(x[:, :1].contiguous(), w[:, :1].contiguous(), None, a, 4, force="rows")
    assert (K.launches, len(fake_lib.calls)) == n


def test_capture_neither_reads_nor_writes_records(fake_lib, monkeypatch):
    """While a stream captures a CUDA graph, the call plans anew, the records and the
    weight copies untouched."""
    x, w, a, t_out = _layer(cin=64, cout=128, t_out=32)
    K._launch(x, w, None, a, 4)
    records = dict(K._records)
    made = []
    plan_call = K._plan_call
    monkeypatch.setattr(K, "_plan_call", lambda *args: made.append(1) or plan_call(*args))
    monkeypatch.setattr(K, "_capturing", lambda: True)
    x2, _, _, _ = _layer(cin=64, cout=128, t_out=16)
    entry, n = K._rows[w], len(K._rows)
    K._launch(x, w, None, a, 4)
    K._launch(x2, w, None, a, 4)
    assert made == [1, 1] and K._records == records
    assert K._rows[w] is entry and len(K._rows) == n
    assert [c for c, _ in fake_lib.calls[-3:]] == ["rows", "rows_encode", "rows"]
    monkeypatch.setattr(K, "_capturing", lambda: False)
    K._launch(x, w, None, a, 4)
    assert made == [1, 1]  # the record made before capture


def test_conv1d_prelu_skips_the_function_without_autograd(monkeypatch):
    """Under inference_mode (and with no input that requires grad) conv1d_prelu calls
    fused_conv1d_prelu itself, with the same outputs; with grad it goes through
    Conv1dPReLU, whose gradients follow."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 4 * 16 + 29, generator=g)
    w = torch.randn(64, 8, KW, generator=g, requires_grad=True)
    b = torch.randn(64, generator=g)
    a = torch.rand(64, generator=g)
    applied = []
    apply = K.Conv1dPReLU.apply
    monkeypatch.setattr(K.Conv1dPReLU, "apply",
                        lambda *args: applied.append(1) or apply(*args))
    want = K.fused_conv1d_prelu(x, w.detach(), b, a, 4)
    with torch.inference_mode():
        got = K.conv1d_prelu(x, w, b, a, 4)
    with torch.no_grad():
        got2 = K.conv1d_prelu(x, w, b, a, 4)
    got3 = K.conv1d_prelu(x, w.detach(), b, a, 4)
    assert applied == []
    for out in (got, got2, got3):
        assert all(torch.equal(o, r) for o, r in zip(out, want))
        assert not out[0].requires_grad
    y, pre = K.conv1d_prelu(x, w, b, a, 4)
    assert applied == [1] and y.requires_grad and y.grad_fn is not None
    assert torch.equal(y, want[0]) and torch.equal(pre, want[1])
    y.sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape


def test_library_builds_on_its_own(monkeypatch, tmp_path):
    """csrc/conv1d_rows.cu is a library of its own; the ring header it shares with the
    wgmma kernels is hashed into its name."""
    for f in build.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("conv1d_rows")
    assert before != build.library_path("conv1d_wgmma")
    (tmp_path / "tma_ring.cuh").write_text("// edited\n")
    assert build.library_path("conv1d_rows") != before
    cmd = build.nvcc_command("nvcc", "conv1d_rows", tmp_path / "x.so")
    assert cmd[-1].endswith("conv1d_rows.cu") and "arch=compute_90a,code=sm_90a" in cmd
