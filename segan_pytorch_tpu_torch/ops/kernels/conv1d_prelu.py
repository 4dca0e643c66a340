"""Fused strided conv1d + bias + PReLU: the port of the Pallas kernel
``segan_pytorch_tpu/ops/pallas/conv1d.py:fused_conv1d_prelu``.

Three pieces, as for every kernel of the port:

- ``conv1d_prelu_plain``: the same function in plain PyTorch. CPU tensors take it, and
  the tests and ``chip_smoke.py`` hold the CUDA kernel against it.
- ``fused_conv1d_prelu``: the wrapper. On a CPU tensor it returns the plain version; on
  a CUDA tensor it launches a hand-written kernel (``csrc/conv1d_prelu.cu``,
  ``csrc/conv1d_wgmma.cu``, ``csrc/conv1d_wgmma_tf32.cu``, ``csrc/conv1d_rows.cu``) or
  raises. ``launches`` counts the wrapper's calls that launch a kernel, ``launches_mma``
  those of them on the tensor cores (both dtypes, every instruction), ``launches_tf32``
  those of them in fp32 (3xTF32, on either instruction), ``launches_wgmma`` those on the
  wgmma route (both dtypes: an fp32 call there moves all four) and ``launches_rows``
  those on the rows route (bf16; they move ``launches_mma`` too). A call under CUDA graph
  capture records the launch into the graph and counts once; the graph's replays run the
  kernel again and move no counter.
- Four routes on the card, chosen by shape and x's layout before launch (``_route``),
  never as a fallback: "rows" (bf16 calls of few rows: ``conv1d_rows_kernel``, swap-AB
  ``mma.sync`` with the weights streamed once by TMA and split-K reduced in a
  thread-block cluster), "wgmma" (TMA and ``wgmma``: bf16 ``conv1d_wgmma_kernel``, fp32 by a 3xTF32
  split ``conv1d_wgmma_tf32_kernel``), "mma" (``mma.sync``: bf16 as it is, fp32 by a
  3xTF32 split) and "fma" (FMAs). The tensor-core routes take stride 4 (SEGAN+) and
  stride 2 (Generator1D), each kernel instantiated for both, but rows (stride 4); the
  FMA kernel any stride. The tensor-core routes take the weights
  padded to 32 taps (``_pad_taps``), in fp32 split into their TF32 parts
  (``_split_tf32``; one copy for both fp32 routes), on the bf16 wgmma route with the
  taps permuted to the MMA fragments' order (``_wgmma_weights``), on the rows route in
  m64-tile order with their TMA tensor map (``_rows_copy``), each made once per weight
  and version (``_padded_weights``, ``_permuted_weights``, ``_rows_weights``; never while
  a CUDA graph is being captured, which records the pad instead).
- A call's checks, route, plan and entry point are made once per call signature
  (``_launch``'s records): a call that has been made before pays a key, the weight
  copy's lookup, its outputs and one ctypes call.
- x may be a view whose rows lie ``pitch`` elements apart (``x.stride()`` == (Cin pitch,
  pitch, 1)): G's and Generator1D's fused blocks pad into rows whose pitch is a multiple
  of 8 (``ops/conv.py`` ``reflect_pad_pitched``, ``zero_pad_pitched``), the layout TMA
  reads. Every kernel takes the pitch; nothing copies x.
- ``conv1d_prelu``: the differentiable op (``Conv1dPReLU``). Its backward mirrors the
  JAX custom VJP ``_bwd`` in plain torch ops, as the JAX backward is not a kernel either.
  Where autograd records nothing it calls ``fused_conv1d_prelu`` directly.

Layout (torch's, not the JAX package's): x (B, Cin, T_in), already padded; w (Cout,
Cin, K); b (Cout,) or None; a (Cout,). Both outputs, y = PReLU(pre) and pre =
conv(x, w) + b, are (B, Cout, T_out) in x's dtype, with T_out = (T_in - K)//stride + 1.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..conv import at_least_fp32, conv1d, conv1d_weight, conv_transpose1d
from . import build

# kernel launches since the counter was last set to 0 (the wrapper alone adds to them):
# all of them, those on the tensor cores, of those the fp32 (3xTF32) ones, those on
# wgmma (both dtypes) and those on the rows kernel (bf16)
launches = 0
launches_mma = 0
launches_tf32 = 0
launches_wgmma = 0
launches_rows = 0
# the counters, the weight caches and the records are shared by every thread that runs G
# (the server's two batchers do)
_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KP = 32  # taps of the tensor-core kernels' weights: K and zero taps
MMA_MIN_SLICE = 4  # input channels per split-K slice of the MMA route, at least
# the wgmma kernels' constants (csrc/conv1d_wgmma.cu, csrc/conv1d_wgmma_tf32.cu): output
# channels per block, input channels per ring stage (bf16, fp32), rows per m64 tile, and
# the block tiles (m64 tiles per consumer warpgroup) each dtype's kernel takes
WGMMA_BN, WGMMA_CC, WGMMA_TF32_CC, WGMMA_ROWS = 128, 4, 2, 64
WGMMA_TILES = {torch.bfloat16: (1, 2), torch.float32: (1,)}
WGMMA_MAX_SPLITS = 16
# _wgmma_plan's cost model, ms = waves (WAVE_MS + CHANNEL_MS m_tiles slice)
# + (splits > 1) (SPLIT_MS + PARTIAL_MS splits B T_out Cout): (WAVE_MS, CHANNEL_MS,
# SPLIT_MS, PARTIAL_MS), fitted to each kernel's device times at every plan
WGMMA_COST = (4.26e-3, 1.91e-4, 2.16e-2, 1.28e-9)
WGMMA_TF32_COST = (1.80e-5, 9.48e-4, 1.62e-2, 3.61e-9)
# the route rule's thresholds by dtype, from same-call timings on the card (``_route``):
# the wgmma route from B T_out rows or B T_out Cout Cin multiply-adds per tap, enc1's
# mma.sync route from B T_out rows; at stride 4 (SEGAN+'s G and D)
WGMMA_MIN_ROWS = {torch.bfloat16: 1 << 10, torch.float32: 1 << 13}
WGMMA_MIN_WORK = {torch.bfloat16: 1 << 28, torch.float32: 1 << 25}
ENC1_MMA_MIN_ROWS = {torch.bfloat16: 1 << 17, torch.float32: 1 << 18}
# and at stride 2 (Generator1D's encoder), with the tensor cores from S2_TC_MIN_WORK
# multiply-adds per tap where the mma.sync kernel would take the shape
S2_WGMMA_MIN_ROWS = {torch.bfloat16: 1 << 11, torch.float32: 1 << 13}
S2_WGMMA_MIN_WORK = {torch.bfloat16: 1 << 28, torch.float32: 1 << 25}
S2_ENC1_MMA_MIN_ROWS = {torch.bfloat16: 1 << 18, torch.float32: 1 << 18}
S2_TC_MIN_WORK = {torch.bfloat16: 1 << 24, torch.float32: 1 << 24}
# (wgmma rows, wgmma work, enc1 mma.sync rows, tensor-core work) by stride
THRESHOLDS = {4: (WGMMA_MIN_ROWS, WGMMA_MIN_WORK, ENC1_MMA_MIN_ROWS,
                  {torch.bfloat16: 0, torch.float32: 0}),
              2: (S2_WGMMA_MIN_ROWS, S2_WGMMA_MIN_WORK, S2_ENC1_MMA_MIN_ROWS,
                  S2_TC_MIN_WORK)}
# the rows kernel's constants (csrc/conv1d_rows.cu): output channels per block, ring
# stages (a channel pair's 8 KB tile each), the weight copy's channel padding, the MMA
# widths it is built for, the cluster sizes, the shared memory a block may use and a
# batch row's staged samples past 4 a row
ROWS_BM, ROWS_STAGES, ROWS_CHANNEL_ALIGN = 64, 8, 8
ROWS_N = (8, 16, 32, 64, 128, 256)
ROWS_CLUSTERS = (1, 2, 4, 8)
ROWS_MAX_SMEM, ROWS_SEG_SLACK = 232448, 40
# the rows plan's targets: at most this many rows a tile (the MMA width n <= 64) and about
# this many blocks (tools/conv1d_routes.py --plans)
ROWS_TILE_ROWS, ROWS_BLOCKS = 64, 128
# the rows route below this many rows (B T_out), in bf16 at stride 4 (``_route``)
ROWS_MAX_ROWS = 256
# the tensor-core routes' weights, by the weight tensor they were made from:
# weight -> (its version when made, copy): padded (and in fp32 split), permuted, and in
# the rows kernel's m64-tile order with its tensor map
_padded = WeakIdKeyDictionary()
_permuted = WeakIdKeyDictionary()
_rows = WeakIdKeyDictionary()
# _launch's records, by call signature (``_signature``), at most MAX_RECORDS
_records = {}
MAX_RECORDS = 4096


def _pad_taps(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, K <= 32) weights as (Cout, Cin, 32), the taps past K zero: the
    counterpart of the Pallas kernels' ``_fold_weights``, which pad 31 taps to 32 too. A
    conv of either stride with these gives the same rows: a window's extra taps add
    zero."""
    return F.pad(w, (0, KP - w.shape[-1])).contiguous()


def _tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` rounds: to
    nearest, ties away from zero, on the 13 low bits of the bit pattern (a carry goes
    into the exponent, so the largest finite values round to infinity). NaN stays NaN."""
    r = ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(v), v, r)


def _split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 v as its two TF32 parts (big, small): big = tf32(v) and small =
    tf32(v - big), so that v = big + small to about 2^-22 |v|."""
    big = _tf32_round(v)
    return big, _tf32_round(v - big)


def _mma_weights(w: torch.Tensor):
    """The tensor-core routes' weights: (Cout, Cin, 32) padded in bf16 (mma.sync); in
    fp32 also split, a (big, small) pair of them (a pair, not one stacked tensor:
    indexing a tensor on every call costs the wrapper microseconds), which both fp32
    routes take, the taps in their order."""
    wp = _pad_taps(w.detach())
    return _split_tf32(wp) if w.dtype == torch.float32 else wp


def _wgmma_weights(w: torch.Tensor) -> torch.Tensor:
    """The bf16 wgmma route's weights: (Cout, Cin, 32), padded and with the taps in the
    order the MMA fragments take them, so that each 16-deep step h reads 32 contiguous
    bytes of a weight row: at contraction index k = 2q + e and 2q + 8 + e (lane quad q,
    e = 0, 1) step h takes the taps 8q + 4h + e and 8q + 4h + 2 + e, as the mma.sync
    route's A fragments do. Tap 8 q + 4 h + 2 kk + e goes to column 16 h + 8 kk + 2 q + e:
    a permutation of the padded taps' (q, h, kk, e) digits, one copy on the device. (The
    fp32 wgmma route reads the taps in their order, 8 a step: ``_mma_weights``.)"""
    cout, cin = w.shape[:2]
    return (_pad_taps(w.detach()).view(cout, cin, 4, 2, 2, 2).permute(0, 1, 3, 4, 2, 5)
            .reshape(cout, cin, KP))


def _cached(cache, w: torch.Tensor, make, capturing: Optional[bool] = None):
    """make(w), kept in `cache` while w lives and its version stays, as
    ``_padded_weights`` says (`capturing`: ``_capturing()``, when the caller has read
    it)."""
    # inference tensors keep no version counter
    if torch.is_inference(w) or (_capturing() if capturing is None else capturing):
        return make(w)
    with _lock:
        hit = cache.get(w)
        if hit is None or hit[0] != w._version:
            hit = cache[w] = (w._version, make(w))
    return hit[1]


def _permuted_weights(w: torch.Tensor, capturing: Optional[bool] = None) -> torch.Tensor:
    """``_wgmma_weights(w)`` (bf16), made once per weight and version, under the rules of
    ``_padded_weights`` (spectral norm's w / sigma is new every forward and misses)."""
    return _cached(_permuted, w, _wgmma_weights, capturing)


def _padded_weights(w: torch.Tensor, capturing: Optional[bool] = None):
    """``_mma_weights(w)``, made once while w lives and is not changed in place, so that
    a model's forward pads no weight on every call (at a batch of one chunk the host time
    of the pad is as long as the kernel). A change in place is seen by w's version
    counter, which an optimizer step or ``load_state_dict`` bumps and which autograd
    also relies on; writes through ``w.data`` bypass it, as they bypass autograd, and so
    do a CUDA graph's replays, after which the graph's owner bumps the versions of what it
    wrote (``models/multistep.py``). While a stream is capturing, the pad (and split) is
    recorded into the graph and the cache is neither read nor written: an entry taken
    then would feed every replay the weights of capture time."""
    return _cached(_padded, w, _mma_weights, capturing)


def _rows_tiles(w: torch.Tensor) -> torch.Tensor:
    """The rows route's weights: (Cout, Cin, K) padded to 32 taps and to a multiple of 8
    input channels (ROWS_CHANNEL_ALIGN), in m64-tile order, (Cout / 64, Cin8 / 2, 64, 64):
    tile (m, p) holds output channels 64 m .. 64 m + 63 (rows) by the taps of input
    channels 2 p and 2 p + 1 (columns), 8 KB in a row, so that each TMA box of a block's
    weight stream is one contiguous read."""
    cout, cin = w.shape[:2]
    cin8 = -(-cin // ROWS_CHANNEL_ALIGN) * ROWS_CHANNEL_ALIGN
    wp = F.pad(_pad_taps(w.detach()), (0, 0, 0, cin8 - cin))
    return (wp.view(cout // ROWS_BM, ROWS_BM, cin8 // 2, 2 * KP).permute(0, 2, 1, 3)
            .contiguous())


def _rows_copy(w: torch.Tensor):
    """The rows kernel's weights (``_rows_tiles``), the tensor map its C entry reads them
    by (128 bytes, encoded here, once per copy) and the map's address."""
    wp = _rows_tiles(w)
    cout, cin = w.shape[:2]
    buf = ctypes.create_string_buffer(128)
    err = _rows_entries()[0](ctypes.addressof(buf), wp.data_ptr(), cout, cin)
    if err != 0:
        raise RuntimeError(f"conv1d_rows: encoding the weights' tensor map failed "
                           f"(cudaError {err})")
    return wp, buf, ctypes.addressof(buf)


def _rows_weights(w: torch.Tensor, capturing: Optional[bool] = None):
    """``_rows_copy(w)`` (bf16), made once per weight and version, under the rules of
    ``_padded_weights``: a call encodes no tensor map."""
    return _cached(_rows, w, _rows_copy, capturing)


def _capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph (never before CUDA is
    initialised; cheaper than asking ``torch.cuda.is_available()``, which reads the
    environment, on every call)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _tensor_core_shape(dtype: torch.dtype, cout: int, k: int, stride: int, t_out: int,
                       wgmma: bool = False) -> bool:
    """Whether the tensor-core kernels take the shape: bf16 or fp32 at stride 4 or 2, K <=
    32, whole n8 tiles of channels and whole m16 tiles of time steps, so that an m16 tile
    never spans two batch rows. The ``wgmma`` kernels at stride 2 stage a window for each
    8-row half of an m16 tile, so there whole halves are enough (T_out % 8 == 0:
    Generator1D's last layer, T_out = 8)."""
    rows = 8 if wgmma and stride == 2 else 16
    return (dtype in _DTYPE_CODES and stride in THRESHOLDS and k <= KP and cout % 8 == 0
            and t_out % rows == 0)


def _wgmma_shape(dtype: torch.dtype, cin: int, cout: int, k: int, stride: int, t_out: int,
                 pitched: bool) -> bool:
    """Whether the wgmma kernels take the call: x in ``pitched`` rows (pitch a multiple of
    8 and x 16-byte aligned, as TMA reads them), Cin > 1, Cout a multiple of 128 and
    ``_tensor_core_shape``'s wgmma shapes."""
    return (pitched and cin > 1 and cout % WGMMA_BN == 0
            and _tensor_core_shape(dtype, cout, k, stride, t_out, wgmma=True))


def _rows_shape(dtype: torch.dtype, cin: int, cout: int, k: int, stride: int) -> bool:
    """Whether the rows kernel takes the shape: bf16 at stride 4, K <= 32, Cin > 1 and
    whole m64 tiles of output channels; any T_out, x in rows of any pitch."""
    return (dtype == torch.bfloat16 and stride == 4 and k <= KP and cin > 1
            and cout % ROWS_BM == 0)


def _rows_smem(n: int, rows_per_tile: int, cluster: int, B: int, cin: int,
               t_out: int) -> int:
    """The dynamic shared memory of a rows block (``Layout`` and ``raw_samples`` of
    csrc/conv1d_rows.cu): the weight ring, the partial sums the block finishes (64 x
    (n + 4) fp32: a slot for each block of the cluster), x's windows of the block's input
    channels (at most 4 samples a row and 40 a batch row the tile touches, rounded up to
    8), each row's offsets, the bias and slope, the batch rows' places, the barriers, and
    1 KB of slack."""
    per = -(-(-(-cin // cluster)) // 2) * 2
    nseg = min(B, (rows_per_tile + t_out - 2) // t_out + 1)
    lr = -(-(4 * rows_per_tile + ROWS_SEG_SLACK * nseg) // 8) * 8
    raw = ROWS_STAGES * ROWS_BM * 2 * KP * 2 + ROWS_BM * (n + 4) * 4
    outbase = -(-(raw + per * lr * 2 + 4 * n) // 8) * 8
    return 1024 + outbase + 8 * n + 2 * ROWS_BM * 4 + 20 * n + (2 * ROWS_STAGES + 1) * 8


def _rows_width(rows: int, tiles: int) -> Tuple[int, int]:
    """(n, rows_per_tile) of `rows` cut into `tiles` row tiles: the narrowest MMA width
    that holds a tile."""
    per = -(-rows // tiles)
    return next(v for v in ROWS_N if v >= per), per


def _rows_fits(B: int, cin: int, t_out: int) -> bool:
    """Whether a rows block's shared memory fits, in the fewest row tiles of at most
    ROWS_TILE_ROWS at the largest cluster (the least x a block stages)."""
    n, per = _rows_width(B * t_out, -(-B * t_out // ROWS_TILE_ROWS))
    return _rows_smem(n, per, ROWS_CLUSTERS[-1], B, cin, t_out) <= ROWS_MAX_SMEM


@functools.lru_cache(maxsize=None)  # a pure function of the shape
def _rows_plan(B: int, cin: int, cout: int, t_out: int, num_sms: int) -> Tuple[int, int, int]:
    """(n, rows_per_tile, cluster) of the rows route, where ``_rows_fits``: the rows cut
    into tiles of at most ROWS_TILE_ROWS, and the cluster (split-K slices of the input
    channels, one a block, at least a ring stage each) the largest with Cout / 64 x tiles x
    cluster <= ROWS_BLOCKS (of one wave: two blocks fit an SM of `num_sms`); then, while
    fewer blocks than that, the tiles halved (down to 8 rows) at the cluster of 8."""
    rows, m_tiles = B * t_out, cout // ROWS_BM
    tiles = -(-rows // ROWS_TILE_ROWS)
    widest = max(c for c in ROWS_CLUSTERS if c <= max(1, cin // 2))
    target = min(ROWS_BLOCKS, 2 * num_sms)
    while m_tiles * tiles * widest < target and -(-rows // (2 * tiles)) >= 8:
        tiles *= 2
    n, per = _rows_width(rows, tiles)
    blocks = m_tiles * -(-rows // per)
    fits = [c for c in ROWS_CLUSTERS if _rows_smem(n, per, c, B, cin, t_out) <= ROWS_MAX_SMEM]
    wave = [c for c in fits if c <= widest and blocks * c <= target]
    return n, per, max(wave) if wave else min(fits)


def _route(dtype: torch.dtype, B: int, cin: int, cout: int, k: int, stride: int,
           t_out: int, pitched: bool = False, rows: bool = True) -> str:
    """Which kernel a CUDA call takes, by shape and x's layout, decided before launch,
    with the thresholds of its stride (THRESHOLDS: 4 for SEGAN+'s G and D, 2 for
    Generator1D's encoder):

    - "fma" (``conv1d_prelu_kernel``) for every shape the tensor cores do not take
      (``_tensor_core_shape``, ``_wgmma_shape``), for enc1 (Cin = 1, bound by bytes: it
      writes y and pre) below the stride's ENC1_MMA_MIN_ROWS[dtype] rows (B T_out), and
      at stride 2 below S2_TC_MIN_WORK[dtype] multiply-adds per tap (the work, B T_out
      Cout Cin) where the mma.sync kernel takes the shape;
    - "wgmma" (bf16 ``conv1d_wgmma_kernel``, fp32 ``conv1d_wgmma_tf32_kernel``) where
      ``_wgmma_shape`` holds and B T_out is at least the stride's WGMMA_MIN_ROWS[dtype]
      or the work at least its WGMMA_MIN_WORK[dtype], and wherever it alone takes the
      shape (stride 2, T_out % 16 == 8: Generator1D's last layer);
    - "rows" (``conv1d_rows_kernel``) where ``_rows_shape`` holds (bf16, stride 4, Cin >
      1), B T_out is at most ROWS_MAX_ROWS and the call has one batch row or a T_out that
      the mma.sync kernel does not take (T_out % 16 != 0), whatever x's layout: serving's
      few-row calls (one chunk's enc3-5, a window's enc2-5 or enc4-5, WSEGAN's padded
      lengths);
    - "mma" (``mma.sync``; fp32 by 3xTF32) for the rest. An x in odd rows (a contiguous
      G pad, T_in = 4 T_out + 29) takes it whatever its shape; so do Generator1D's layers
      with fewer than 128 output channels.

    ``rows=False`` gives the route the rule gives without the rows kernel (the one it
    replaced, for same-call comparisons).

    The rows route rests on device times (NVIDIA H100 80GB HBM3 at 700.00 W):
    chip_smoke.py phase 3 (10 launches back to back through the entry points) took at one
    chunk's enc3, enc4 and enc5 0.0120, 0.0118 and 0.0144 ms against mma.sync's 0.0149,
    0.0156 and 0.0188, at a window of 2048's enc2-3 0.0092 and 0.0081 against 0.0137 and
    0.0116, and at ragged T_out 0.0091-0.0391 against the FMA kernel's 0.0434-0.1647 (a
    call 5 back to back 0.035-0.055 ms against 0.049-0.173);
    tools/conv1d_routes.py --plans (CUDA graphs of 10 calls: the device alone) at one chunk
    0.0112 / 0.0108 / 0.0130 against mma.sync's 0.0139 / 0.0148 / 0.0165, while with
    several batch rows at T_out % 16 == 0 mma.sync drew level or ahead (enc5: B = 3 0.0294
    at the rows kernel's best plan against 0.0263, B = 8 0.0382 against 0.0369), hence one
    batch row or a ragged T_out.

    The figures it rests on: a call's cost with calls back to back, as in a G forward
    (the longer of the wrapper's host time and the device's; tools/conv1d_routes.py, 10
    calls per timing, measured on one NVIDIA H100 80GB HBM3 at 700 W). At G's
    encoder shapes wgmma took 0.26-0.43x of mma.sync's time at 64-300 chunks and
    0.30-0.74x at 32 (2^28 of work at every layer); below that, 0.46-0.93x where a layer
    has 1024 rows or more (enc2 from one chunk, enc3 from 4, enc4 from 16) but for enc3
    at 8 chunks (1.02x), while mma.sync was as fast or faster at the layers with fewer
    rows (enc4 and enc5 at 1-8 chunks, enc5 at 16: 0.0377-0.0659 ms against
    0.0399-0.0689) but enc3 at one chunk, within the spread (0.0937 against 0.0859,
    interquartile ranges 0.03). At enc1 the FMA kernel beat mma.sync up to 16 chunks in
    bf16 (0.0418 against 0.0545 at 16) and lost from 32 (0.0593 against 0.0527); in fp32
    it won up to 32 (0.0600 against 0.0723) and lost from 64 (0.1105 against 0.1047).

    In fp32 (both tensor-core routes 3xTF32; the same measure, NVIDIA H100 80GB HBM3 at
    700.00 W): wgmma took 0.25-0.42x of mma.sync's time at G's encoder shapes of 64-300
    chunks, 0.29-0.47x at 16-32, 0.41-0.75x at 8 and 0.84-1.04x at 4 (2^25 of work at
    every layer: enc2-5 summed 0.2840 ms against 0.3020, 0.94x, and 0.94x and 1.00x in
    two earlier runs); at 1-2 chunks 0.98-1.44x, mma.sync the faster at 7 of those 8
    layers: a wgmma call costs the host more (three tensor maps a launch). Hence 2^25 of
    work, or 2^13 rows (enc2: 0.0681 ms against 0.1678 at 8192 rows, 0.0773 against
    0.0743 at 4096).

    At stride 2 (Generator1D's 11 layers, x padded by (15, 15) into pitched rows; the
    same measure, tools/conv1d_routes.py --stride 2 at 1-64 chunks, two runs, NVIDIA H100
    80GB HBM3 at 700.00 W): at one chunk (2^21 multiply-adds a tap) the FMA kernel was as
    fast or faster at 16 of the 18 shapes below the last layer (the other two within
    9 %); at 4 chunks (2^23) it won 4 of 9 layers in each dtype, about even summed; from 8
    chunks (2^24) the tensor cores won all but one layer in fp32 and 7 of 9 in bf16 (the
    others 4 % and 14 % slower), hence S2_TC_MIN_WORK. The last layer (T_out 8) on wgmma
    took 0.065-0.19 ms against the FMA kernel's 0.16-1.02 at 1-64 chunks. enc1 (Cout 16)
    on mma.sync lost up to 16 chunks (bf16 0.0741 ms against 0.0555 at 16) and won from
    32 (0.0660 against 0.0749), in fp32 alike (0.0667 against 0.0746 at 32). wgmma against
    mma.sync in bf16: at 1024 rows mma.sync was faster at three of five shapes, by 10-27 %
    (64 chunks, the tenth layer: 0.0806 against 0.1000), from 2048 rows wgmma won or tied
    but at two (by 10-11 %), hence 2^11 rows; in fp32 the stride-4 thresholds fit: wgmma
    took 0.31-0.39x of mma.sync's time at 64 chunks, 0.45-0.73x at 32, mixed at 16, lost
    at 8.
    """
    if (rows and _rows_shape(dtype, cin, cout, k, stride) and B * t_out <= ROWS_MAX_ROWS
            and (B == 1 or t_out % 16) and _rows_fits(B, cin, t_out)):
        return "rows"
    mma = _tensor_core_shape(dtype, cout, k, stride, t_out)
    wgmma = _wgmma_shape(dtype, cin, cout, k, stride, t_out, pitched)
    if not (mma or wgmma):
        return "fma"
    min_rows, min_work, enc1_rows, tc_work = THRESHOLDS[stride]
    rows, work = B * t_out, B * t_out * cout * cin
    if cin == 1:
        return "mma" if rows >= enc1_rows[dtype] else "fma"
    if mma and work < tc_work[dtype]:
        return "fma"
    if wgmma and (not mma or rows >= min_rows[dtype] or work >= min_work[dtype]):
        return "wgmma"
    return "mma" if mma else "fma"


@functools.lru_cache(maxsize=None)
def _mma_plan(B: int, cin: int, cout: int, t_out: int, num_sms: int, stride: int = 4,
              dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(warps_m, splits) of the MMA route. The block tile is warps_m x (8 / warps_m) warps
    of 64 rows x 32 channels: 4 x 2 for Cout <= 64 (enc1), 2 x 4 for Cout <= 128 and more
    than 64 rows (enc2), else 1 x 8, the widest, which stages the least x per MMA. At
    stride 2 (Generator1D's encoder; tools/conv1d_routes.py --stride 2 --plans, NVIDIA
    H100 80GB HBM3 at 700 W), 8 x 1 for Cin = 1 in either dtype and for Cout <= 32 in
    fp32, which took 0.79-0.80x of 4 x 2's device time at 64 chunks (in bf16 at Cout 32
    it took 1.6-1.7x, so 4 x 2 stays there), and the split count rounded down to a power
    of two: 3, 5 and 9 slices took 1.2-1.5x the time of 2, 4 and 8."""
    if stride == 2 and (cin == 1 or (cout <= 32 and dtype == torch.float32)):
        warps_m = 8
    else:
        warps_m = 4 if cout <= 64 else (2 if cout <= 128 and B * t_out > 64 else 1)
    splits = _mma_splits(B, cin, cout, t_out, num_sms, warps_m)
    if stride == 2:
        per = -(-cin // (1 << (splits.bit_length() - 1)))
        splits = -(-cin // per)  # as the kernel cuts them
    return warps_m, splits


@functools.lru_cache(maxsize=None)  # a pure function of the shape, on every call's path
def _wgmma_plan(B: int, cin: int, cout: int, t_out: int, num_sms: int,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(m_tiles, splits) of the wgmma route: the block tile (128 m_tiles rows x 128
    channels, one block per SM; m_tiles of WGMMA_TILES[dtype]) and the split-K slices
    (whole ring stages of WGMMA_CC channels in bf16, WGMMA_TF32_CC in fp32, none empty),
    the plan of least cost under the dtype's model (WGMMA_COST, WGMMA_TF32_COST): the
    waves of blocks on `num_sms` SMs, each as long as its slice of channels at its rows,
    and a split-K epilogue that reads back splits x B x T_out x Cout fp32 partial sums.
    The models pick plans whose summed device times are within 1.2 % (bf16, over all
    2 x 16 plans) and 1.1-1.5 % (fp32, over every split-K count) of the fastest ones' at the
    encoder's shapes of 1-300 chunks (tools/conv1d_routes.py --plans, measured on one
    NVIDIA H100 80GB HBM3 at 700 W)."""
    fp32 = dtype == torch.float32
    wave_ms, channel_ms, split_ms, partial_ms = WGMMA_TF32_COST if fp32 else WGMMA_COST
    cc = WGMMA_TF32_CC if fp32 else WGMMA_CC
    rows, n_tiles = B * t_out, cout // WGMMA_BN
    best = None
    for m_tiles in WGMMA_TILES[dtype]:
        for splits in range(1, WGMMA_MAX_SPLITS + 1):
            per = -(-(-(-cin // splits)) // cc) * cc  # channels per slice
            if -(-cin // per) != splits:  # the kernel would cut fewer slices
                continue
            blocks = -(-rows // (2 * WGMMA_ROWS * m_tiles)) * n_tiles * splits
            cost = -(-blocks // num_sms) * (wave_ms + channel_ms * m_tiles * per)
            if splits > 1:
                cost += split_ms + partial_ms * splits * rows * cout
            if best is None or cost < best[0]:
                best = (cost, m_tiles, splits)
    return best[1], best[2]


def _mma_splits(B: int, cin: int, cout: int, t_out: int, num_sms: int,
                warps_m: int) -> int:
    """Split-K slices of the MMA route for a tile of warps_m x (8 / warps_m) warps: when
    the tiles would not give every SM a block, the input channels are cut into slices of
    at least MMA_MIN_SLICE, aiming at two blocks per SM. Counts the slices, none of them
    empty, as the kernel cuts them."""
    tiles = -(-B * t_out // (64 * warps_m)) * -(-cout // (256 // warps_m))
    splits = 1
    if tiles < num_sms:
        splits = max(1, min(-(-2 * num_sms // tiles), cin // MMA_MIN_SLICE))
    per = -(-cin // splits)
    return -(-cin // per)


def _prelu(pre: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(pre, 0) + a.view(1, -1, 1) * torch.clamp_max(pre, 0)


def conv1d_prelu_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                       a: torch.Tensor, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (y, pre)."""
    pre = conv1d(x, w, b, stride)
    return _prelu(pre, a), pre


def _check(x, w, b, a, stride) -> int:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"need x (B, Cin, T_in) and w (Cout, Cin, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, cin, t_in = x.shape
    cout, w_cin, k = w.shape
    if w_cin != cin:
        raise ValueError(f"x has {cin} channels, w expects {w_cin}")
    if a.shape != (cout,) or (b is not None and b.shape != (cout,)):
        raise ValueError(f"b and a must be ({cout},), got "
                         f"{None if b is None else tuple(b.shape)} and {tuple(a.shape)}")
    if not isinstance(stride, int) or stride < 1:
        raise ValueError(f"stride must be a positive int, got {stride!r}")
    t_out = (t_in - k) // stride + 1
    if t_out < 1:
        raise ValueError(f"input of length {t_in} is shorter than the kernel ({k})")
    tensors = [x, w, a] + ([b] if b is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w, b and a must lie on one device")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"x, w, b and a must share one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    return t_out


@functools.cache
def _entries():
    lib = build.load_library("conv1d_prelu")
    launch = lib.conv1d_prelu_launch
    launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    launch.restype = ctypes.c_int
    splits = lib.conv1d_prelu_splits
    splits.argtypes = [ctypes.c_int] * 6
    splits.restype = ctypes.c_int
    launch_mma = lib.conv1d_prelu_mma_launch
    launch_mma.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    launch_mma.restype = ctypes.c_int
    launch_tf32 = lib.conv1d_prelu_tf32_launch
    launch_tf32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    launch_tf32.restype = ctypes.c_int
    return launch, splits, launch_mma, launch_tf32


@functools.cache
def _wgmma_entry(dtype: torch.dtype = torch.bfloat16):
    """The wgmma route's entry point for `dtype`, each source a library of its own:
    conv1d_prelu_wgmma_launch of csrc/conv1d_wgmma.cu (bf16: one weight pointer) or
    conv1d_prelu_wgmma_tf32_launch of csrc/conv1d_wgmma_tf32.cu (fp32: the split
    weights' two), the other arguments alike."""
    fp32 = dtype == torch.float32
    lib = build.load_library("conv1d_wgmma_tf32" if fp32 else "conv1d_wgmma")
    fn = lib.conv1d_prelu_wgmma_tf32_launch if fp32 else lib.conv1d_prelu_wgmma_launch
    fn.argtypes = [ctypes.c_void_p] * (8 if fp32 else 7) + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _rows_entries():
    """The rows route's library (csrc/conv1d_rows.cu): conv1d_rows_encode, which encodes
    a weight copy's tensor map, and conv1d_rows_launch."""
    lib = build.load_library("conv1d_rows")
    encode = lib.conv1d_rows_encode
    encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    encode.restype = ctypes.c_int
    launch = lib.conv1d_rows_launch
    launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return encode, launch


@functools.cache
def _sm_count(device_index) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _pitch(x: torch.Tensor) -> int:
    """The distance, in elements, between x's rows of samples: x (B, Cin, T_in) with unit
    stride in time, rows ``pitch`` >= T_in apart and batch rows Cin pitch apart (a
    contiguous x: T_in). Raises for any other layout, which no kernel reads: nothing
    copies x."""
    B, cin, t_in = x.shape
    if x.is_contiguous():
        return t_in
    pitch = x.stride(1) if cin > 1 else x.stride(0)
    if ((x.stride(2) != 1 and t_in > 1) or pitch < t_in
            or (B > 1 and x.stride(0) != cin * pitch)):
        raise ValueError(f"the CUDA kernels read x (B, Cin, T_in) in rows of one pitch, "
                         f"(Cin pitch, pitch, 1); got strides {x.stride()}")
    return pitch


class _Call:
    """What every call of one signature launches (``_launch``'s record): T_out, the
    route, the counters it moves, the entry point with its leading and trailing fixed
    arguments (the plan among them), the outputs' shape, the split-K workspace's shape
    (or None; ``slot`` False where the entry takes no workspace argument), whether
    outputs given must be 16-byte aligned, and x's device index."""

    __slots__ = ("t_out", "route", "counts", "fn", "head", "ints", "shape", "partial",
                 "slot", "aligned", "index")


def _signature(x, w, b, a, stride, force):
    """A call's key in ``_records``: every property of its inputs that ``_check`` and
    ``_plan_call`` read (shapes, strides, dtypes, devices, x's 16-byte alignment, the
    stride and its type), and the forced route."""
    return (x.shape, x.stride(), x.dtype, x.device, x.data_ptr() % 16 == 0, w.shape,
            w.stride(), w.dtype, w.device,
            None if b is None else (b.shape, b.stride(), b.dtype, b.device),
            a.shape, a.stride(), a.dtype, a.device, type(stride), stride, force)


def _check_out(rec: _Call, x, out):
    """``out`` (y, pre) must be two contiguous tensors of the call's shape, dtype and
    device, 16-byte aligned where the route stores 16-byte units."""
    if any(o.shape != rec.shape or o.dtype != x.dtype or o.device != x.device
           or not o.is_contiguous() for o in out):
        raise ValueError(f"out must be two contiguous {x.dtype} tensors on {x.device} of "
                         f"shape {rec.shape}")
    if rec.aligned and (out[0].data_ptr() % 16 or out[1].data_ptr() % 16):
        raise ValueError(f"the {rec.route} route stores 16-byte units: y and pre must be "
                         "16-byte aligned")


def _plan_call(x, w, b, a, stride, force, out=None) -> _Call:
    """The record of a call: every check the call must pass (``_check``'s, the dtype,
    the layouts, the 32-bit sizes, the route's shape, and ``out``'s when given, before
    anything is built), the route (``_route``'s, or `force`: "fma", "mma", "wgmma" or
    "rows", which raises where that route does not take the shape or layout), its plan
    and its entry point."""
    t_out = _check(x, w, b, a, stride)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if not all(t.is_contiguous() for t in (w, a) + ((b,) if b is not None else ())):
        raise ValueError("the CUDA kernel needs contiguous w, b and a")
    B, cin, t_in = x.shape
    cout, _, k = w.shape
    pitch = _pitch(x)
    if max(B, cin * KP, pitch, cout, B * t_out) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's 32-bit size arguments")
    pitched = pitch % 8 == 0 and x.data_ptr() % 16 == 0
    if force is None:
        route = _route(x.dtype, B, cin, cout, k, stride, t_out, pitched)
    elif force == "fma" or (force in ("mma", "wgmma") and _tensor_core_shape(
            x.dtype, cout, k, stride, t_out, wgmma=force == "wgmma")) or (
            force == "rows" and _rows_shape(x.dtype, cin, cout, k, stride)
            and _rows_fits(B, cin, t_out)):
        route = force
    else:
        raise ValueError(f"the {force!r} route does not take this shape")
    if route == "wgmma" and not _wgmma_shape(x.dtype, cin, cout, k, stride, t_out, pitched):
        raise ValueError("the wgmma route takes x in 16-byte aligned rows whose pitch is "
                         "a multiple of 8, Cin > 1 and Cout a multiple of 128")
    rec = _Call()
    rec.t_out, rec.route, rec.index = t_out, route, x.device.index
    tf32 = route != "fma" and x.dtype == torch.float32
    rec.counts = (route != "fma", tf32, route == "wgmma", route == "rows")
    rec.shape = (B, cout, t_out)
    rec.aligned = route in ("wgmma", "mma") and not (route == "mma" and tf32)
    if out is not None:
        _check_out(rec, x, out)
    rec.head, rec.slot, splits = (), True, 1
    sms = _sm_count(x.device.index)
    sizes = (B, cin, t_in, pitch, cout, t_out)
    if route == "rows":
        rec.fn = _rows_entries()[1]
        rec.ints = (*_rows_plan(B, cin, cout, t_out, sms), *sizes)
        rec.slot = False
    elif route == "wgmma":
        rec.fn = _wgmma_entry(x.dtype)
        tiles, splits = _wgmma_plan(B, cin, cout, t_out, sms, x.dtype)
        rec.ints = (tiles, splits, *sizes, stride)
    else:
        launch, splits_of, launch_mma, launch_tf32 = _entries()
        if route == "mma":
            rec.fn = launch_tf32 if tf32 else launch_mma
            tiles, splits = _mma_plan(B, cin, cout, t_out, sms, stride, x.dtype)
            rec.ints = (tiles, splits, *sizes, stride)
        else:
            rec.fn, rec.head = launch, (_DTYPE_CODES[x.dtype],)
            splits = splits_of(B, cin, cout, t_out, k, sms)
            rec.ints = (splits, *sizes, k, stride)
    # split-K workspace: fp32 partial sums, one (B, Cout, T_out) slab per depth slice
    rec.partial = (splits, B, cout, t_out) if splits > 1 else None
    return rec


def _current_device() -> int:
    return torch._C._cuda_getDevice()


def _current_stream(index: int) -> int:
    """The handle of device `index`'s current stream (torch.cuda.current_stream(index)
    .cuda_stream, without making a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(x, w, b, a, stride: int, t_out: Optional[int] = None,
            out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            force: Optional[str] = None):
    """Launch a kernel on CUDA tensors, into ``out`` (y, pre) when it is given, else into
    new tensors. ``force`` ("fma", "mma", "wgmma" or "rows") takes that route in place of
    ``_route``'s, for same-call comparisons; it raises where the route does not take the
    shape or layout. `t_out`, when given, must be the call's.

    A call signature's checks, route, plan and entry point are made once, into a record
    (``_Call``, kept in ``_records`` by ``_signature``); a call whose signature has one
    pays its key, the weight copy's lookup, the outputs and one ctypes call. Every input
    that a check refuses raises as it did before its record was made: the key holds every
    property the checks read. While a stream is capturing a CUDA graph, records (like the
    weight copies) are neither read nor written."""
    global launches, launches_mma, launches_tf32, launches_wgmma, launches_rows
    capturing = _capturing()
    key = _signature(x, w, b, a, stride, force)
    rec = None if capturing else _records.get(key)
    if rec is None:
        rec = _plan_call(x, w, b, a, stride, force, out)
        if not capturing:
            with _lock:
                if len(_records) >= MAX_RECORDS:
                    _records.clear()
                _records[key] = rec
    elif out is not None:
        _check_out(rec, x, out)
    if t_out is not None and t_out != rec.t_out:
        raise ValueError(f"T_out is {rec.t_out} for this call, not {t_out}")
    if out is None:
        y = torch.empty(rec.shape, dtype=x.dtype, device=x.device)
        pre = torch.empty(rec.shape, dtype=x.dtype, device=x.device)
    else:
        y, pre = out
    route = rec.route
    if route == "fma":
        wk, wptrs = w, (w.data_ptr(),)
    elif route == "rows":
        wk = _rows_weights(w, capturing)
        wptrs = (wk[2],)
    elif route == "wgmma" and x.dtype == torch.bfloat16:
        wk = _permuted_weights(w, capturing)
        wptrs = (wk.data_ptr(),)
    else:
        wk = _padded_weights(w, capturing)
        wptrs = ((wk[0].data_ptr(), wk[1].data_ptr()) if x.dtype == torch.float32
                 else (wk.data_ptr(),))
    partial = (torch.empty(rec.partial, dtype=torch.float32, device=x.device)
               if rec.partial is not None else None)
    args = (*rec.head, x.data_ptr(), *wptrs, b.data_ptr() if b is not None else None,
            a.data_ptr(), y.data_ptr(), pre.data_ptr())
    if rec.slot:
        args += (partial.data_ptr() if partial is not None else None,)
    if rec.index == _current_device():
        err = rec.fn(*args, *rec.ints, _current_stream(rec.index))
    else:
        with torch.cuda.device(rec.index):
            err = rec.fn(*args, *rec.ints, _current_stream(rec.index))
    del wk
    if err != 0:
        raise RuntimeError(f"conv1d_prelu kernel launch failed ({route} route): "
                           f"cudaError {err}")
    tc, tf32, wg, rows = rec.counts
    with _lock:
        launches += 1
        launches_mma += tc
        launches_tf32 += tf32
        launches_wgmma += wg
        launches_rows += rows
    return y, pre


def fused_conv1d_prelu(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                       a: torch.Tensor, stride: int = 4
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, pre) = (PReLU(conv(x, w) + b, a), conv(x, w) + b).

    CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    if x.is_cuda:
        return _launch(x, w, b, a, stride)
    _check(x, w, b, a, stride)
    if x.device.type == "cpu":
        return conv1d_prelu_plain(x, w, b, a, stride)
    raise ValueError(f"fused_conv1d_prelu runs on cpu or cuda, not {x.device}")


class Conv1dPReLU(torch.autograd.Function):
    """Differentiable ``fused_conv1d_prelu``; backward as the JAX ``_bwd``."""

    @staticmethod
    def forward(ctx, x, w, b, a, stride):
        y, pre = fused_conv1d_prelu(x, w, b, a, stride)
        ctx.stride = stride
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w, a, pre)
        return y, pre

    @staticmethod
    def backward(ctx, gy, gpre):
        x, w, a, pre = ctx.saved_tensors
        s = ctx.stride
        # PReLU: dpre = gy * (pre > 0 ? 1 : a) + gpre; da = sum gy * min(pre, 0)
        af = at_least_fp32(a).view(1, -1, 1)
        gyf, pref = at_least_fp32(gy), at_least_fp32(pre)
        dpre = torch.where(pref > 0, gyf, gyf * af) + at_least_fp32(gpre)
        da = (gyf * torch.clamp_max(pref, 0)).sum(dim=(0, 2)).to(a.dtype)
        db = dpre.sum(dim=(0, 2)).to(a.dtype) if ctx.has_bias else None
        dpre = dpre.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv_transpose1d(dpre, w, stride=s)
            # when (T_in - K) % stride != 0 the last samples touch no window: zero grad
            dx = F.pad(dx, (0, x.shape[2] - dx.shape[2]))
        if ctx.needs_input_grad[1]:
            dw = conv1d_weight(x, w.shape, dpre, stride=s)
        return dx, dw, db, da, None


def conv1d_prelu(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 a: torch.Tensor, stride: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused conv + bias + PReLU; see the module docstring. Where autograd
    records nothing (grad mode off, as under ``torch.inference_mode()``, or no input that
    requires grad) it calls ``fused_conv1d_prelu`` itself: the same outputs, without the
    ``autograd.Function``'s cost on every call."""
    if not torch.is_grad_enabled() or not (
            x.requires_grad or w.requires_grad or a.requires_grad
            or (b is not None and b.requires_grad)):
        return fused_conv1d_prelu(x, w, b, a, stride)
    return Conv1dPReLU.apply(x, w, b, a, stride)
