"""The port's chained enc2 + enc3 op (segan_pytorch_tpu_torch/ops/kernels/encoder_fused.py)
and its A/B tool against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py. Layouts: JAX h1 (B, T1, C1),
w (K, Cin, Cout); the port h1 (B, C1, T1), w (Cout, Cin, K).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models.generator import build_generator as jax_build
from segan_pytorch_tpu.ops.pallas import encoder_fused as jef
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench
from segan_pytorch_tpu_torch.utils.checkpoint import generator_state_from_jax
from segan_pytorch_tpu_torch.utils.config import SEGANConfig

TOL = 1e-5  # fp32, two CPU conv implementations summing in different orders
ROOT = Path(__file__).resolve().parents[1]


def _jax_inputs(B, T1, C1, C2, C3, bias, seed=0):
    """Numpy inputs in JAX layout: weights at 1/sqrt(31 Cin), slopes U(0, 0.3); with
    bias=False the biases are None (the JAX kernel then gets zeros)."""
    rng = np.random.RandomState(seed)
    h1 = rng.randn(B, T1, C1).astype(np.float32)
    w2 = (rng.randn(31, C1, C2) / np.sqrt(31 * C1)).astype(np.float32)
    w3 = (rng.randn(31, C2, C3) / np.sqrt(31 * C2)).astype(np.float32)
    b2 = rng.randn(C2).astype(np.float32) * 0.1 if bias else None
    b3 = rng.randn(C3).astype(np.float32) * 0.1 if bias else None
    a2 = rng.uniform(0, 0.3, C2).astype(np.float32)
    a3 = rng.uniform(0, 0.3, C3).astype(np.float32)
    return h1, w2, b2, a2, w3, b3, a3


def _to_port(h1, w2, b2, a2, w3, b3, a3):
    t = lambda v: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
    return (t(h1.transpose(0, 2, 1)), t(w2.transpose(2, 1, 0)), t(b2), t(a2),
            t(w3.transpose(2, 1, 0)), t(b3), t(a3))


def _from_port(v):
    """A port tensor (B, C, T) as a JAX-layout array (B, T, C)."""
    return v.detach().numpy().transpose(0, 2, 1)


def _jax_fused(h1, w2, b2, a2, w3, b3, a3):
    zeros = lambda c: np.zeros(c, np.float32)
    args = (h1, w2, zeros(w2.shape[2]) if b2 is None else b2, a2,
            w3, zeros(w3.shape[2]) if b3 is None else b3, a3)
    return [np.asarray(v) for v in jef.fused_enc23_fwd(*map(jnp.asarray, args),
                                                       batch_tile=2, interpret=True)]


@pytest.mark.parametrize("bias", [True, False])
def test_matches_pallas_interpret(bias):
    """tests/test_pallas.py's shapes (B 4, T1 256, C 8/16/32)."""
    inputs = _jax_inputs(4, 256, 8, 16, 32, bias)
    want = _jax_fused(*inputs)
    before = EF.launches
    got = EF.fused_enc23_fwd(*_to_port(*inputs))
    assert EF.launches == before  # CPU tensors take the plain version: no launch
    for g, w in zip(got, want):
        np.testing.assert_allclose(_from_port(g), w, rtol=TOL, atol=TOL)


def test_full_width_tool_data_matches_pallas_interpret():
    """B 2, T1 4096, C 64/128/256, the tool's data: the same numpy arrays go through the
    JAX kernel; make_inputs draws what tools/encoder_fused_bench.py draws."""
    port = bench.make_inputs(2, dtype=torch.float32)
    rng = np.random.RandomState(0)  # the JAX tool's recipe, its order and scales
    f32 = lambda *shape: rng.randn(*shape).astype(np.float32)
    recipe = [f32(2, 4096, 64) * 0.1, f32(31, 64, 128) * 0.05, f32(128) * 0.05,
              f32(128) * 0.05, f32(31, 128, 256) * 0.05, f32(256) * 0.05, f32(256) * 0.05]
    for got, want in zip(_to_port(*recipe), port):
        assert torch.equal(got, want)
    want = _jax_fused(*recipe)
    got = EF.fused_enc23_fwd(*port)
    for g, w in zip(got, want):
        err = np.abs(_from_port(g) - w).max() / np.abs(w).max()
        assert g.shape[0] == 2 and err <= TOL, err


def test_slice_through_carried_weights():
    """A JAX Generator's enc_blocks 1 and 2, carried into the port's G: the chained op
    on JAX's enc_0 output gives JAX's enc_2 output, and its pre-activations are the port's
    own blocks' (ret_linear)."""
    toy = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4],
               gkwidth=31, z_dim=32, no_bias=True)
    G = jax_build(JaxConfig(**toy))
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 1024, 1))
    rng = np.random.RandomState(3)
    flat = {}
    for path, v in flatten_tree(G.init({"params": key, "z": key}, x)["params"]).items():
        if path.endswith("act/weight"):
            flat[path] = rng.uniform(0, 0.3, v.shape).astype(np.float32)
        elif v.ndim == 3:
            flat[path] = (rng.randn(*v.shape) / np.sqrt(v.shape[0] * v.shape[1])
                          ).astype(np.float32)
        else:
            flat[path] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    wav = rng.randn(2, 1024, 1).astype(np.float32) * 0.3
    z = rng.randn(2, 16, 32).astype(np.float32)
    _, hall = G.apply({"params": unflatten_tree(flat)}, jnp.asarray(wav),
                      z=jnp.asarray(z), ret_hid=True, train=False)
    tg = build_generator(SEGANConfig(**toy))
    tg.load_state_dict(generator_state_from_jax(flat), strict=True)
    e2, e3 = tg.enc_blocks[1], tg.enc_blocks[2]
    h1 = torch.from_numpy(np.ascontiguousarray(np.asarray(hall["enc_0"]).transpose(0, 2, 1)))
    assert h1.shape == (2, 8, 256) and e2.conv.bias is None
    with torch.no_grad():
        pre2, pre3, post3 = EF.fused_enc23_fwd(h1, e2.conv.weight, None, e2.act.weight,
                                               e3.conv.weight, None, e3.act.weight)
        post2, pre2_blk = e2(h1, ret_linear=True)
        post3_blk, pre3_blk = e3(post2, ret_linear=True)
    np.testing.assert_allclose(_from_port(post3), np.asarray(hall["enc_2"]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(pre2.numpy(), pre2_blk.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pre3.numpy(), pre3_blk.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(post3.numpy(), post3_blk.numpy(), rtol=TOL, atol=TOL)


def test_tool_arms_agree_on_cpu():
    inputs = bench.make_inputs(1, t1=256, dtype=torch.float32)
    assert list(bench.ARMS) == ["plain chain", "kernel x2", "fused 2+3"]
    outs = {name: arm(*inputs) for name, arm in bench.ARMS.items()}
    shapes = [(1, 128, 64), (1, 256, 16), (1, 256, 16)]
    for name, out in outs.items():
        assert [tuple(v.shape) for v in out] == shapes, name
        for v, ref in zip(out, outs["plain chain"]):
            np.testing.assert_allclose(v.numpy(), ref.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=name)


def test_tool_main_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--batch", "1"])


# enc23_mma_kernel's tiling, its constants as in csrc/encoder_fused.cu
TILE, SLOTS, MA, WIN, CC = 32, 156, 160, 668, 16


def _mma_taps():
    """taps[h, k]: the tap that MMA step h of an input channel takes at contraction index
    k. In the m16n8k16 fragments lane quad q holds k = 2q, 2q + 1 and 2q + 8, 2q + 9; the
    kernel loads taps 8q + 4h + 0..3 of its row (A) and of its channel (B) there."""
    taps = np.empty((2, 16), np.int64)
    for h in range(2):
        for q in range(4):
            taps[h, [2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9]] = 8 * q + 4 * h + np.arange(4)
    return taps


def _reflect(r, n):
    r = np.abs(r)
    return np.where(r >= n, 2 * n - 2 - r, r)


def _prelu(p, a):
    return np.maximum(p, 0) + a * np.minimum(p, 0)


def _emulate_mma_kernel(h1, w2, b2, a2, w3, b3, a3):
    """What enc23_mma_kernel computes, block by block, in float64 numpy (port layout):
    the h1 window staged CC channels at a time (reflected at T1 from the even row 4 lo,
    clamped past the end), the 32-tap padded weights, post2 by padded slot with the mirror
    fill at both ends, and the A operand read at 4 m + tap. Output rows that no block
    writes stay NaN."""
    B, C1, T1 = h1.shape
    C2, C3 = w2.shape[0], w3.shape[0]
    T2, T3 = T1 // 4, T1 // 16
    w2p, w3p = (EF._pad_taps(torch.from_numpy(w)).numpy() for w in (w2, w3))
    b2 = np.zeros(C2) if b2 is None else b2
    b3 = np.zeros(C3) if b3 is None else b3
    taps = _mma_taps()
    pre2 = np.full((B, C2, T2), np.nan)
    pre3, post3 = np.full((B, C3, T3), np.nan), np.full((B, C3, T3), np.nan)
    dot = lambda a, w: np.tensordot(a, w, axes=([0, 2], [1, 2]))  # (ci, m, k) x (n, ci, k)
    for b in range(B):
        for t0 in range(0, T3, TILE):
            t_end = min(t0 + TILE, T3)
            p0 = 4 * t0 - 14  # the real post2 row of slot 0
            lo, hi = max(0, p0), min(T2 - 1, p0 + SLOTS - 1)
            assert lo % 2 == 0
            # phase A: rows m < MA; window row j is padded h1 row 4 lo + j
            win = np.clip(_reflect(4 * lo + np.arange(WIN) - 14, T1), 0, T1 - 1)
            m = np.arange(MA)[:, None]
            acc = np.zeros((MA, C2))
            for c0 in range(0, C1, CC):
                xs = h1[b, c0:c0 + CC][:, win]
                for h in range(2):
                    acc += dot(xs[:, 4 * m + taps[h]], w2p[:, c0:c0 + CC][:, :, taps[h]])
            pre = acc[:hi - lo + 1] + b2
            post2 = np.full((C2, SLOTS), np.nan)  # slot s: padded post2 row 4 t0 + s
            post2[:, lo - p0:hi - p0 + 1] = _prelu(pre, a2).T
            pre2[b, :, 4 * t0:4 * t_end] = pre[4 * t0 - lo:4 * t_end - lo].T
            for s in range(SLOTS):
                r = p0 + s
                if lo <= r <= hi:
                    continue
                src = -r if r < 0 else 2 * T2 - 2 - r
                post2[:, s] = post2[:, src - p0] if lo <= src <= hi else 0.0
            assert not np.isnan(post2).any()
            # phase B: rows m < TILE, those past t_end discarded
            m = np.arange(TILE)[:, None]
            acc = sum(dot(post2[:, 4 * m + taps[h]], w3p[:, :, taps[h]]) for h in range(2))
            pre = acc[:t_end - t0] + b3
            pre3[b, :, t0:t_end] = pre.T
            post3[b, :, t0:t_end] = _prelu(pre, a3).T
    return pre2, pre3, post3


def test_mma_taps_cover_the_padded_taps():
    taps = _mma_taps()
    assert sorted(taps.ravel()) == list(range(EF.KP))
    # each lane's four A values of a row, and eight B values of both steps, are adjacent
    for q in range(4):
        quad = taps[:, [2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9]]
        assert quad.ravel().tolist() == list(range(8 * q, 8 * q + 8))


@pytest.mark.parametrize("B,T1,C1,C2,C3,bias", [
    (1, 4096, 64, 128, 256, False),  # SEGAN+ widths, 8 tiles
    (3, 64, 5, 24, 40, True),        # one tile touching both mirrored ends
    (2, 592, 5, 24, 40, False),      # a last tile of 5 rows
], ids=["full width B=1", "T1=64", "ragged T1=592"])
def test_mma_kernel_index_maps_match_plain(B, T1, C1, C2, C3, bias):
    inputs = [None if v is None else torch.from_numpy(np.ascontiguousarray(v)).double()
              for v in _to_port(*_jax_inputs(B, T1, C1, C2, C3, bias))]
    want = EF.enc23_plain(*inputs)
    got = _emulate_mma_kernel(*[None if v is None else v.numpy() for v in inputs])
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("T1", [64, 592, 4096])
def test_pad_taps_adds_a_zero_tap(T1):
    rng = np.random.RandomState(T1)
    x = EF.reflect_pad_1d(torch.from_numpy(rng.randn(2, 5, T1)), *EF.PAD)
    w = torch.from_numpy(rng.randn(7, 5, EF.K))
    wp = EF._pad_taps(w)
    assert x.shape[2] == T1 + 29 and wp.shape == (7, 5, EF.KP) and wp.is_contiguous()
    assert torch.equal(wp[..., :EF.K], w) and not wp[..., EF.K:].any()
    want = torch.nn.functional.conv1d(x, w, stride=EF.S)
    got = torch.nn.functional.conv1d(x, wp, stride=EF.S)
    assert got.shape == (2, 7, T1 // EF.S)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_bf16_launch_needs_whole_n8_tiles():
    """The bf16 kernel's rule, which _launch checks before it reaches the card (on the
    card chip_smoke.py checks it too); the public wrapper takes the plain version here."""
    args = [None if v is None else v.bfloat16()
            for v in _to_port(*_jax_inputs(1, 64, 5, 24, 36, True))]
    before = EF.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        EF._launch(*args)
    assert EF.launches == before


def _bad_inputs(case):
    args = list(_to_port(*_jax_inputs(1, 128, 3, 4, 5, True)))
    if case == "T1 % 16":
        args[0] = args[0][..., :120]
    elif case == "T1 < 64":
        args[0] = args[0][..., :48]
    elif case == "K != 31":
        args[1] = args[1][..., :29]
    elif case == "channel mismatch":
        args[4] = args[4][:, :3]
    elif case == "mixed dtypes":
        args[4] = args[4].double()
    elif case == "meta device":
        args = [v.to("meta") for v in args]
    return args


@pytest.mark.parametrize("case,exc", [
    ("T1 % 16", ValueError),
    ("T1 < 64", ValueError),
    ("K != 31", ValueError),
    ("channel mismatch", ValueError),
    ("mixed dtypes", TypeError),
    ("meta device", ValueError),  # neither cpu nor cuda: no silent fallback
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    before = EF.launches
    with pytest.raises(exc):
        EF.fused_enc23_fwd(*_bad_inputs(case))
    assert EF.launches == before


def test_build_targets_hopper():
    cmd = build.nvcc_command("nvcc", "encoder_fused", Path("lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/encoder_fused.cu") and Path(cmd[-1]).exists()
    assert build.library_path("encoder_fused").parent == build.BUILD_DIR


def test_new_modules_import_no_jax():
    """As tests/test_torch_config.py checks the whole port: the sources name no jax, and
    with jax unimportable the op and the tool run on the CPU."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|segan_pytorch_tpu)\b(?!_torch)",
                     re.M)
    files = [ROOT / "segan_pytorch_tpu_torch/ops/kernels/encoder_fused.py",
             ROOT / "segan_pytorch_tpu_torch/tools/encoder_fused_bench.py"]
    assert not [f for f in files if pat.search(f.read_text())]
    code = """
import sys
sys.modules['jax'] = None
import torch
from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench
outs = [arm(*bench.make_inputs(1, t1=64, dtype=torch.float32)) for arm in bench.ARMS.values()]
assert all(o[2].shape == (1, 256, 4) for o in outs)
assert not [m for m in sys.modules if m.split('.')[0] in ('segan_pytorch_tpu', 'flax', 'optax')]
print('ok')
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
