"""The port's fused conv + bias + PReLU (segan_pytorch_tpu_torch/ops/kernels) against the
JAX package's Pallas kernel, run in interpret mode on the CPU, and its XLA reference.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py. Layouts: JAX x (B, T, C),
w (K, Cin, Cout); the port x (B, C, T), w (Cout, Cin, K).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.ops.conv import conv1d, reflect_pad_1d
from segan_pytorch_tpu.ops.pallas import conv1d as plconv
from segan_pytorch_tpu_torch.ops.kernels import build
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

FWD_TOL = 1e-5   # fp32, two CPU conv implementations summing in different orders
GRAD_TOL = 1e-4  # as tests/test_pallas.py's gradient parity


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _inputs(B, L, cin, cout, k, s, seed=0):
    """Padded x (B, T_in, Cin) as the JAX block pads it, w (K, Cin, Cout), b, and
    slopes a in U(0, 0.3), so the negative branch is exercised."""
    x = _rand(B, L, cin, seed=seed)
    w = _rand(k, cin, cout, seed=seed + 1) / float(np.sqrt(k * cin))
    b = _rand(cout, seed=seed + 2) * 0.1
    a = np.random.RandomState(seed + 3).uniform(0, 0.3, cout).astype(np.float32)
    P = (k // 2 - 1, k // 2) if s > 1 else (k // 2, k // 2)
    x_p = np.asarray(reflect_pad_1d(jnp.asarray(x), *P))
    return x_p, w, b, a


def _to_port(x_p, w, b, a):
    return (torch.from_numpy(np.ascontiguousarray(x_p.transpose(0, 2, 1))),
            torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))),
            None if b is None else torch.from_numpy(b), torch.from_numpy(a))


def _from_port(t):
    return t.detach().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("B,L,cin,cout,k,s", [
    (2, 256, 4, 8, 31, 4),
    (1, 128, 8, 16, 31, 1),
    (2, 64, 3, 8, 5, 2),
])
def test_forward_matches_pallas_interpret(B, L, cin, cout, k, s):
    x_p, w, b, a = _inputs(B, L, cin, cout, k, s)
    y_j, pre_j = plconv.fused_conv1d_prelu(
        jnp.asarray(x_p), jnp.asarray(w), jnp.asarray(b), jnp.asarray(a), s, 256, True)
    before = K.launches
    y, pre = K.fused_conv1d_prelu(*_to_port(x_p, w, b, a), s)
    assert K.launches == before  # CPU tensors take the plain version: no launch
    np.testing.assert_allclose(_from_port(y), np.asarray(y_j), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(_from_port(pre), np.asarray(pre_j), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("with_bias", [True, False])
def test_bottleneck_shape_matches_xla(with_bias):
    """K=31, s=4, T_out=16 (enc5's geometry): the Pallas kernel refuses it
    (pallas_applicable), so hold the port against JAX conv1d + PReLU."""
    x_p, w, b, a = _inputs(3, 64, 6, 12, 31, 4, seed=4)
    if not with_bias:
        b = None
    pre_j = conv1d(jnp.asarray(x_p), jnp.asarray(w),
                   None if b is None else jnp.asarray(b), stride=4)
    y_j = jnp.maximum(pre_j, 0) + jnp.asarray(a) * jnp.minimum(pre_j, 0)
    assert pre_j.shape[1] == 16 and not plconv.pallas_applicable(x_p.shape[1], 31, 4)
    y, pre = K.fused_conv1d_prelu(*_to_port(x_p, w, b, a), 4)
    np.testing.assert_allclose(_from_port(y), np.asarray(y_j), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(_from_port(pre), np.asarray(pre_j), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("B,L,cin,cout,k,s", [
    (2, 128, 4, 8, 31, 4),
    (2, 64, 3, 8, 5, 2),
])
def test_grads_match_pallas_custom_vjp(B, L, cin, cout, k, s):
    """Gradients of x, w, b, a through the port's autograd.Function against jax.grad
    through the interpret-mode kernel's custom VJP, with a loss on both outputs."""
    x_p, w, b, a = _inputs(B, L, cin, cout, k, s, seed=7)
    # one sample more than the windows use when (T_in - K) % s != 0: zero grad there
    x_p = np.concatenate([x_p, x_p[:, -1:]], axis=1)

    def loss_j(x, w, b, a):
        y, pre = plconv.fused_conv1d_prelu(x, w, b, a, s, 256, True)
        return jnp.sum(y ** 2) + jnp.sum(pre * 0.1)

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x_p, w, b, a)))
    xt, wt, bt, at = (t.requires_grad_() for t in _to_port(x_p, w, b, a))
    y, pre = K.conv1d_prelu(xt, wt, bt, at, s)
    (torch.sum(y ** 2) + torch.sum(pre * 0.1)).backward()
    np.testing.assert_allclose(_from_port(xt.grad), np.asarray(g_j[0]), atol=GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 1, 0), np.asarray(g_j[1]),
                               atol=GRAD_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(g_j[2]), atol=GRAD_TOL)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(g_j[3]), atol=GRAD_TOL)


def test_grads_without_bias_match_autograd_of_plain():
    """b=None (--no_bias): the Function's hand-written backward equals torch autograd
    through the plain ops."""
    x_p, w, _, a = _inputs(2, 96, 5, 7, 31, 4, seed=9)
    args = [t.requires_grad_() for t in _to_port(x_p, w, None, a) if t is not None]
    y, pre = K.conv1d_prelu(args[0], args[1], None, args[2], 4)
    (torch.sum(y ** 3) + torch.sum(pre)).backward()
    ref = [t.detach().clone().requires_grad_() for t in args]
    pre_r = torch.nn.functional.conv1d(ref[0], ref[1], stride=4)
    y_r = torch.clamp_min(pre_r, 0) + ref[2].view(1, -1, 1) * torch.clamp_max(pre_r, 0)
    (torch.sum(y_r ** 3) + torch.sum(pre_r)).backward()
    for got, want in zip(args, ref):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, b, a = _to_port(*_inputs(1, 64, 3, 8, 5, 2))
    with pytest.raises(ValueError):
        K.fused_conv1d_prelu(x, w[:, :2], b, a, 2)  # channel mismatch
    with pytest.raises(ValueError):
        K.fused_conv1d_prelu(x, w, b[:4], a, 2)  # bias of the wrong size
    with pytest.raises(TypeError):
        K.fused_conv1d_prelu(x, w.double(), b, a, 2)  # mixed dtypes
    with pytest.raises(ValueError):
        K.fused_conv1d_prelu(x[..., :3], w, b, a, 2)  # shorter than the kernel
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent fallback
        K.fused_conv1d_prelu(*(t.to("meta") for t in (x, w, b, a)), 2)


def test_build_targets_hopper_and_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    cmd = build.nvcc_command("nvcc", "conv1d_prelu", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/conv1d_prelu.cu")
    assert build.library_path("conv1d_prelu").parent == build.BUILD_DIR
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
