"""The tensor-core route of the port's fused conv + bias + PReLU
(segan_pytorch_tpu_torch/csrc/conv1d_prelu.cu, ``conv1d_mma_kernel``), its route rule,
its measuring tools, and the port's TF32 and device policies.

No card here: a float64 numpy emulation of exactly the kernel's index maps (per m16 group
windows, channel chunks, the 32 padded taps in the order the MMA fragments take them,
samples past T_in staged as 0, split-K slices cut on channels and summed in the epilogue's
order, the warps' tiles) is held against the plain version at full SEGAN+ width and
against the JAX Pallas kernel in interpret mode. On the card chip_smoke.py holds the
kernel itself against the plain version. Layouts as in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from segan_pytorch_tpu.ops.conv import reflect_pad_1d
from segan_pytorch_tpu.ops.pallas import conv1d as plconv
from segan_pytorch_tpu_torch import clean
from segan_pytorch_tpu_torch.models import segan as tsegan
from segan_pytorch_tpu_torch.ops import conv as conv_ops
from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
from segan_pytorch_tpu_torch.tools import conv1d_mma_ab as ab
from segan_pytorch_tpu_torch.tools import g_profile
from segan_pytorch_tpu_torch.utils.config import SEGANConfig

# conv1d_mma_kernel's constants, as in csrc/conv1d_prelu.cu
WG, STAGED, MMA_MT = 96, 128, 4
H100_SMS = 132
T, KW = 16384, 31
CHANS = [1, 64, 128, 256, 512, 1024]


def _main_path(B, layer):
    """(B, Cin, T_in, Cout) of encoder layer `layer` (0-4) for B 16384-sample chunks."""
    t_out = T // 4 ** (layer + 1)
    return B, CHANS[layer], 4 * t_out + KW - 2, CHANS[layer + 1]  # G pads by 29


def _mma_taps():
    """taps[h, k]: the tap that MMA step h of an input channel takes at contraction
    index k (lane quad q holds k = 2q, 2q + 1, 2q + 8, 2q + 9: taps 8q + 4h + 0..3)."""
    taps = np.empty((2, 16), np.int64)
    for h in range(2):
        for q in range(4):
            taps[h, [2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9]] = 8 * q + 4 * h + np.arange(4)
    return taps


def _emulate_mma_kernel(x, w, b, a, num_sms=H100_SMS, shift=0):
    """What conv1d_mma_kernel computes, in float64 numpy (port layout): (y, pre), NaN
    where no warp writes. `shift` moves every staged window by that many samples (a
    mutation the comparisons must catch)."""
    B, cin, t_in = x.shape
    cout, _, k = w.shape
    t_out = (t_in - k) // 4 + 1
    assert K._tensor_core_shape(torch.bfloat16, cout, k, 4, t_out)
    wp = K._pad_taps(torch.from_numpy(w)).numpy()
    warps_m, splits = K._mma_plan(B, cin, cout, t_out, num_sms)
    nq, tile_n = MMA_MT * warps_m, 256 // warps_m
    cc_max = STAGED // nq
    per = -(-cin // splits)
    assert -(-cin // per) == splits  # the kernel's slices: none empty
    M = B * t_out
    groups = M // 16
    gb, gt0 = np.divmod(np.arange(groups) * 16, t_out)  # group q: batch row, first step
    taps, r = _mma_taps(), np.arange(16)
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
            for h in range(2):
                A = xs[:, :, 4 * r[:, None] + taps[h][None, :]]  # (group, ch, row, k)
                A = A.transpose(0, 2, 1, 3).reshape(groups * 16, -1)
                partial[z] += A @ wp[:, ch][:, :, taps[h]].reshape(cout, -1).T
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
                rows = slice(16 * q, 16 * q + 16)
                for n0 in range(0, -(-cout // tile_n) * tile_n, 32):  # every warp's n0
                    nt_live = min(4, max(0, (cout - n0) // 8))
                    ch = slice(n0, n0 + 8 * nt_live)
                    steps = slice(gt0[q], gt0[q] + 16)
                    pre[gb[q], ch, steps] = pre_rows[rows, ch].T
                    y[gb[q], ch, steps] = y_rows[rows, ch].T
    return y, pre


def _inputs(B, cin, t_in, cout, k=KW, bias=False, seed=0):
    """float64 port-layout inputs: x (B, Cin, T_in) already padded, w at 1/sqrt(K Cin),
    slopes U(0, 0.3) so that the negative branch counts."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, cin, t_in)
    w = rng.randn(cout, cin, k) / np.sqrt(k * cin)
    b = rng.randn(cout) * 0.1 if bias else None
    a = rng.uniform(0, 0.3, cout)
    return x, w, b, a


def _check_against_plain(x, w, b, a, **emulate):
    y, pre = _emulate_mma_kernel(x, w, b, a, **emulate)
    t = lambda v: None if v is None else torch.from_numpy(v)
    y_ref, pre_ref = K.conv1d_prelu_plain(t(x), t(w), t(b), t(a), 4)
    np.testing.assert_allclose(pre, pre_ref.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(y, y_ref.numpy(), rtol=1e-10, atol=1e-10)


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
    """The JAX kernel (interpret mode) on its own layout: x (B, T, C) reflect-padded as
    its block pads it, w (K, Cin, Cout); T_out 64 takes the MMA route."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 256, 4).astype(np.float32)
    w = (rng.randn(KW, 4, 8) / np.sqrt(KW * 4)).astype(np.float32)
    b = (rng.randn(8) * 0.1).astype(np.float32)
    a = rng.uniform(0, 0.3, 8).astype(np.float32)
    x_p = np.asarray(reflect_pad_1d(jnp.asarray(x), KW // 2 - 1, KW // 2))
    y_j, pre_j = plconv.fused_conv1d_prelu(
        jnp.asarray(x_p), jnp.asarray(w), jnp.asarray(b if bias else np.zeros_like(b)),
        jnp.asarray(a), 4, 256, True)
    y, pre = _emulate_mma_kernel(x_p.transpose(0, 2, 1).astype(np.float64),
                                 w.transpose(2, 1, 0).astype(np.float64),
                                 b.astype(np.float64) if bias else None, a.astype(np.float64))
    assert pre.shape == (2, 8, 64)
    np.testing.assert_allclose(pre.transpose(0, 2, 1), np.asarray(pre_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.transpose(0, 2, 1), np.asarray(y_j), rtol=1e-5, atol=1e-5)


def test_mma_taps_cover_the_padded_taps():
    assert sorted(_mma_taps().ravel()) == list(range(K.KP))


@pytest.mark.parametrize("B", [1, 8, 64, 300])
@pytest.mark.parametrize("layer", range(5), ids=[f"enc{i + 1}" for i in range(5)])
def test_main_path_takes_the_mma_route(B, layer):
    """x in contiguous rows (an odd T_in): mma.sync, but for enc1's FMA rows and the rows
    route's few-row layers (test_torch_conv1d_rows.py)."""
    _, cin, t_in, cout = _main_path(B, layer)
    t_out = (t_in - KW) // 4 + 1
    assert t_out == T // 4 ** (layer + 1)
    enc1_fma = layer == 0 and B * t_out < K.ENC1_MMA_MIN_ROWS[torch.bfloat16]
    few_rows = layer > 0 and B == 1 and B * t_out <= K.ROWS_MAX_ROWS
    assert K._route(torch.bfloat16, B, cin, cout, KW, 4, t_out) == (
        "fma" if enc1_fma else "rows" if few_rows else "mma")
    warps_m, splits = K._mma_plan(B, cin, cout, t_out, H100_SMS)
    assert warps_m == {64: 4, 128: 2}.get(cout, 1)
    per = -(-cin // splits)
    assert -(-cin // per) == splits and (splits == 1 or per >= K.MMA_MIN_SLICE)
    tiles = -(-B * t_out // (64 * warps_m)) * -(-cout // (256 // warps_m))
    if layer > 0:  # enc1 has one input channel: nothing to split
        assert tiles * splits >= H100_SMS or per == K.MMA_MIN_SLICE


@pytest.mark.parametrize("dtype,cout,k,stride,t_out", [
    (torch.float32, 128, 31, 4, 250),    # fp32 off the main path: T_out % 16 != 0
    (torch.bfloat16, 40, 31, 1, 270),    # stride 1 (chip_smoke.py's stride-1 case)
    (torch.bfloat16, 70, 31, 4, 243),    # ragged (chip_smoke.py's T_out = 243 case)
    (torch.bfloat16, 68, 31, 4, 256),    # Cout % 8 != 0
    (torch.bfloat16, 64, 31, 4, 250),    # T_out % 16 != 0
    (torch.bfloat16, 64, 33, 4, 256),    # more taps than the padded 32
    (torch.bfloat16, 64, 31, 2, 250),    # stride 2 off whole 8-row halves of time
    (torch.bfloat16, 64, 31, 3, 256),    # another stride
    (torch.float32, 40, 31, 1, 270),     # fp32 off the main path as bf16: stride 1,
    (torch.float32, 70, 31, 4, 243),     # ragged,
    (torch.float32, 68, 31, 4, 256),     # Cout % 8 != 0,
    (torch.float32, 64, 33, 4, 256),     # more taps than the padded 32
], ids=["fp32", "stride 1", "ragged", "Cout%8", "T_out%16", "K=33", "stride 2",
        "stride 3", "fp32 stride 1", "fp32 ragged", "fp32 Cout%8", "fp32 K=33"])
def test_other_shapes_take_the_fma_route(dtype, cout, k, stride, t_out):
    assert K._route(dtype, 64, 64, cout, k, stride, t_out, pitched=True) == "fma"


def test_pad_taps_is_shared_with_the_chained_kernel():
    """Moved from encoder_fused.py; its tests (test_torch_encoder_fused.py) still reach
    it there."""
    assert EF._pad_taps is K._pad_taps and EF.KP == K.KP == 32
    w = torch.randn(3, 2, 5)
    wp = K._pad_taps(w)
    assert wp.shape == (3, 2, 32) and torch.equal(wp[..., :5], w) and not wp[..., 5:].any()


def test_mma_route_refuses_unaligned_outputs():
    """The MMA kernel stores 16-byte units: outputs that are views 2 bytes into a buffer
    are refused before anything is built or launched."""
    x, w, _, a = (None if v is None else torch.from_numpy(v).bfloat16()
                  for v in _inputs(*_main_path(1, 4)))
    buf = torch.empty(2 * 1024 * 16 + 1, dtype=torch.bfloat16)
    out = (buf[1:1 + 1024 * 16].view(1, 1024, 16), buf[:1024 * 16].view(1, 1024, 16))
    before = (K.launches, K.launches_mma)
    with pytest.raises(ValueError, match="16-byte"):
        K._launch(x, w, None, a, 4, 16, out=out, force="mma")
    assert (K.launches, K.launches_mma) == before


def test_padded_weights_are_made_once_per_weight_and_version():
    """bf16 weights are padded; fp32 ones are also split (test_torch_conv1d_tf32.py)."""
    w = torch.randn(8, 3, 31).bfloat16()
    wp = K._padded_weights(w)
    assert torch.equal(wp, K._pad_taps(w)) and K._padded_weights(w) is wp
    with torch.no_grad():
        w.mul_(2)  # in place: a new version
    wp2 = K._padded_weights(w)
    assert wp2 is not wp and torch.equal(wp2, K._pad_taps(w))
    other = w.clone()
    assert K._padded_weights(other) is not wp2
    with torch.inference_mode():
        inf = torch.randn(8, 3, 31).bfloat16()
    assert torch.equal(K._padded_weights(inf), K._pad_taps(inf))
    n = len(K._padded)
    del other
    assert len(K._padded) == n - 1  # an entry lives as long as its weight


def _record_flags(monkeypatch):
    """Patch the conv functions the port's ops call to record the cuDNN flags that are
    in force when they run."""
    seen = []
    for mod, name in ((torch.nn.functional, "conv1d"),
                      (torch.nn.functional, "conv_transpose1d"),
                      (torch.nn.grad, "conv1d_weight")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen.append((_name, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled))
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    return seen


def test_fp32_convs_run_with_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    enabled = torch.backends.cudnn.enabled
    seen = _record_flags(monkeypatch)
    x, w, b, a = (torch.from_numpy(v).float().requires_grad_()
                  for v in _inputs(2, 3, 62, 8, bias=True))
    conv_ops.conv1d(x, w, b, 4)
    conv_ops.conv_transpose1d(torch.randn(1, 8, 5), torch.randn(8, 3, 31), stride=4)
    y, pre = K.conv1d_prelu(x, w, b, a, 4)
    (y.sum() + pre.sum()).backward()
    assert {name for name, _, _ in seen} == {"conv1d", "conv_transpose1d", "conv1d_weight"}
    assert all(tf32 is False and en == enabled for _, tf32, en in seen), seen
    assert torch.backends.cudnn.allow_tf32 is True  # the caller's setting, restored


def test_bf16_convs_leave_tf32_alone(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = _record_flags(monkeypatch)
    conv_ops.conv1d(torch.randn(1, 2, 40).bfloat16(), torch.randn(4, 2, 31).bfloat16())
    assert seen == [("conv1d", True, torch.backends.cudnn.enabled)]


def test_tf32_setting_is_restored_when_the_conv_raises(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError):
        conv_ops.conv1d(torch.randn(1, 2, 40), torch.randn(4, 3, 31))  # channel mismatch
    assert torch.backends.cudnn.allow_tf32 is True


def test_tf32_policy_holds_across_threads(monkeypatch):
    """Threads that run convs at once (a server's batchers and handlers) each see TF32
    off for as long as they are inside the policy's context, however the others enter
    and leave it (fault C4: each context restored the flags it found on entry, so one
    thread's exit turned TF32 back on under another's conv); the caller's setting comes
    back when the last one leaves."""
    import sys
    import threading
    import time

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", True)
    seen, interval = [], sys.getswitchinterval()

    def worker():
        for _ in range(300):
            with conv_ops.full_precision(torch.float32), conv_ops._NO_ONEDNN:
                with conv_ops.full_precision(torch.float32):  # re-entered, as the step does
                    time.sleep(0)  # another thread runs here
                    seen.append((torch.backends.cudnn.allow_tf32,
                                 torch.backends.cuda.matmul.allow_tf32,
                                 torch.backends.mkldnn.enabled))
                seen.append((torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.mkldnn.enabled))

    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts) and len(seen) == 8 * 600
    assert set(seen) == {(False, False, False)}
    assert torch.backends.cudnn.allow_tf32 is True and torch.backends.mkldnn.enabled is True


def test_no_silent_cpu_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsegan.default_device()
    toy = SEGANConfig(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4],
                      z_dim=32, no_bias=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsegan.SEGAN(toy)
    assert tsegan.SEGAN(toy, device="cpu").device.type == "cpu"


def test_cli_device_defaults_to_cuda():
    parser = clean.build_parser()
    assert parser.parse_args([]).device == "cuda"
    assert parser.parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        parser.parse_args(["--device", "tpu"])


def test_ab_tool_variants_apply_to_the_kernel_source():
    """Each diagnostic variant of tools/conv1d_mma_ab.py is the kernel's source with its
    one edit: the edits must keep matching csrc/conv1d_prelu.cu."""
    sources = ab.variant_sources()
    assert list(sources) == ["as is", "no MMAs", "no staging", "no stores",
                             "staging per element", "stores from fragments"]
    src = sources["as is"]
    assert src == (build.CSRC_DIR / "conv1d_prelu.cu").read_text()
    assert len(set(sources.values())) == len(sources)  # every edit changed something
    for name, edit in ab.EDITS.items():
        if isinstance(edit, tuple):
            assert sources[name].count(edit[1]) == 1, name
    assert "uint4" not in sources["stores from fragments"].split("conv1d_mma_kernel(")[1]


@pytest.mark.parametrize("tool", [ab, g_profile], ids=["conv1d_mma_ab", "g_profile"])
def test_tools_need_cuda(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::conv1d_mma_kernel<1>(...)", 0),
    ("void (anonymous namespace)::conv1d_tf32_kernel<2>(...)", 0),
    ("void (anonymous namespace)::conv1d_wgmma_kernel<2>(CUtensorMap_st, ...)", 0),
    ("void (anonymous namespace)::conv1d_wgmma_tf32_kernel(CUtensorMap_st, ...)", 0),
    ("void (anonymous namespace)::splitk_epilogue_kernel<float>(...)", 0),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816dgrad_optimized>", 1),
    ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(...)", 1),
    ("void at::native::reflection_pad1d_out_kernel<float>(...)", 2),
    ("void at::native::CatArrayBatchedCopy_vectorized<...>", 3),
    ("void vector_fft_r2c<float, 2048u>(...)", 5),
    ("void gemv2T_kernel_val<int, int, float, float, float, 128, 16>(...)", 6),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>", None),
])
def test_profile_kernel_classes(name, cls):
    want = "elementwise and other" if cls is None else g_profile.CLASSES[cls][0]
    assert g_profile.kernel_class(name) == want


def test_library_name_covers_the_shared_header(monkeypatch, tmp_path):
    """An edit of csrc/mma_bf16.cuh rebuilds both kernels' libraries."""
    for f in build.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = {n: build.library_path(n) for n in ("conv1d_prelu", "encoder_fused")}
    (tmp_path / "mma_bf16.cuh").write_text("// edited\n")
    assert all(build.library_path(n) != p for n, p in before.items())
