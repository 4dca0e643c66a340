"""The last public names of the JAX package's ``ops/signal.py`` and ``data/augment.py``
that the port lacked, held against the JAX functions on the same seeded inputs: the
torch versions of ``denormalize_wave_minmax``, ``abs_short_normalize_wave_minmax``,
``dynamic_normalize_wave_minmax``, ``pre_emphasize`` and ``de_emphasize`` (on tensors of
any leading shape, float32 and float64), and ``ComposeAdditive`` over ``Additive`` bit
for bit for one ``RandomState`` seed."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segan_pytorch_tpu.data.augment import (Additive as JaxAdditive,
                                            ComposeAdditive as JaxComposeAdditive)
from segan_pytorch_tpu.ops import signal as jsig
from segan_pytorch_tpu_torch.data.augment import Additive, ComposeAdditive
from segan_pytorch_tpu_torch.ops import signal as tsig
from test_torch_augment import _speech, write_noises


def _pcm(shape, seed):
    return np.random.RandomState(seed).randint(-32768, 32767, shape).astype(np.int16)


def test_normalizations_equal_the_jax_ones():
    """denormalize (upstream's formula) on a tensor as the JAX function on a device
    array; the int16-scale and min-max normalisations equal the JAX numpy results."""
    pcm = _pcm(5000, 0)
    x = tsig.normalize_wave_minmax(pcm)
    got = tsig.denormalize_wave_minmax(torch.from_numpy(x))
    want = np.asarray(jsig.denormalize_wave_minmax(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    got = tsig.abs_short_normalize_wave_minmax(torch.from_numpy(pcm.astype(np.float32)))
    want = jsig.abs_short_normalize_wave_minmax(pcm.astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    for x_in in (pcm, torch.from_numpy(pcm)):
        got = tsig.dynamic_normalize_wave_minmax(x_in)
        want = jsig.dynamic_normalize_wave_minmax(pcm)
        assert got.dtype == torch.float64 and want.dtype == np.float64
        np.testing.assert_array_equal(got.numpy(), want)
        assert float(got.min()) == -1.0 and float(got.max()) == 1.0


@functools.lru_cache(maxsize=None)
def _jax_emphasis(shape):
    """The JAX functions' (pre, de) of the float32 signal of `shape` (JAX computes in
    float32 here), once per shape."""
    x = _signal(shape, np.float32)
    return tuple(np.asarray(fn(jnp.asarray(x), 0.95))
                 for fn in (jsig.pre_emphasize, jsig.de_emphasize))


def _signal(shape, dtype):
    rng = np.random.RandomState(len(shape) + shape[-1])
    return (rng.randn(*shape) * 0.3).astype(np.float64).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5000), (2, 2, 4096)])
def test_pre_and_de_emphasis_equal_the_jax_ones(shape, dtype):
    """Both along the last axis of (..., T). Against the JAX functions (float32, as JAX
    computes here) within 1e-5 of the signal's peak: de-emphasis is a parallel scan on
    both sides, in other orders. In float64 also against the exact filters (numpy's
    difference, scipy's lfilter) within 1e-12. De-emphasis undoes pre-emphasis; a
    coefficient of 0 returns the input."""
    from scipy.signal import lfilter

    x = _signal(shape, dtype)
    t = torch.from_numpy(x)
    pre, de = tsig.pre_emphasize(t, 0.95), tsig.de_emphasize(t, 0.95)
    assert pre.shape == de.shape == t.shape and pre.dtype == de.dtype == t.dtype
    exact_de = lfilter([1.0], [1.0, -0.95], x.astype(np.float64), axis=-1)
    scale = max(float(np.abs(exact_de).max()), 1.0)
    for got, want in zip((pre, de), _jax_emphasis(shape)):
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    tol = 1e-5 if dtype == np.float32 else 1e-12
    exact_pre = np.concatenate([x[..., :1], x[..., 1:] - 0.95 * x[..., :-1]], axis=-1)
    assert float(np.abs(pre.numpy() - exact_pre).max()) <= tol * scale
    assert float(np.abs(de.numpy() - exact_de).max()) <= tol * scale
    back = tsig.de_emphasize(pre, 0.95)
    assert float((back - t).abs().max()) <= tol * scale
    assert tsig.pre_emphasize(t, 0.0) is t and tsig.de_emphasize(t, 0.0) is t


def test_compose_additive_equals_the_jax_one(tmp_path):
    """ComposeAdditive keeps the clean slice beside Additive's noisy one: both packages'
    pairs equal bit for bit for the same noises and RandomState seed."""
    noises = write_noises(tmp_path / "noises")
    port = ComposeAdditive(Additive(noises, [0, 5, 10], rng=np.random.RandomState(9)))
    jax_t = JaxComposeAdditive(JaxAdditive(noises, [0, 5, 10],
                                           rng=np.random.RandomState(9)))
    for i in range(4):
        x = _speech(16384, 30 + i) * 0.3
        (cx, nx), (jcx, jnx) = port(x), jax_t(x)
        assert cx is x and jcx is x
        np.testing.assert_array_equal(nx, jnx)
        assert nx.shape == (16384,) and not np.array_equal(nx, x)
