"""The port's copies of the speech-quality metrics (``segan_pytorch_tpu_torch/metrics``)
against the JAX package's originals on the same signals, to 1e-9: SSNR, WSS, LLR, the
LPC coefficients, the composite (CSIG, CBAK, COVL with PESQ and SSNR) and PESQ itself
under the native C++ pipeline and the spectral approximation. Both packages build
``native/pesq862.cpp`` with the same flags, so they score with one yardstick."""
import numpy as np
import pytest

from segan_pytorch_tpu import metrics as jm
from segan_pytorch_tpu.metrics import pesq_native as jpn
from segan_pytorch_tpu_torch import metrics as tm
from segan_pytorch_tpu_torch.metrics import pesq_native as tpn

TOL = dict(rtol=1e-9, atol=1e-12)


def _signals(kind: str, seed: int = 0):
    """(reference, degraded), 1.2 s at 16 kHz: a voiced-like tone complex, degraded by
    white noise at 10 dB, by noise and a 40-sample delay, or with an exact-zero pause
    (LPC frames of zeros)."""
    rng = np.random.RandomState(seed)
    n = 19200
    t = np.arange(n) / 16000.0
    ref = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.3, 180), (0.15, 360), (0.05, 900)))
    ref = ref * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    if kind == "pause":
        ref[6000:9000] = 0.0
    noise = rng.randn(n) * np.sqrt(np.mean(ref ** 2) / 10.0)
    deg = ref + noise
    if kind == "delay":
        deg = np.concatenate([np.zeros(40), deg[:-40]])
    return ref.astype(np.float32), deg.astype(np.float32)


KINDS = ["noise", "delay", "pause"]


@pytest.mark.parametrize("kind", KINDS)
def test_ssnr_wss_llr_equal(kind):
    ref, deg = _signals(kind)
    for got, want in zip(tm.SSNR(ref, deg, 16000), jm.SSNR(ref, deg, 16000)):
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(tm.wss(ref, deg, 16000), jm.wss(ref, deg, 16000), **TOL)
    np.testing.assert_allclose(tm.llr(ref, deg, 16000), jm.llr(ref, deg, 16000), **TOL)


def test_lpcoeff_equal():
    frame = _signals("noise")[1][:512].astype(np.float64)
    for got, want in zip(tm.lpcoeff(frame, 16), jm.lpcoeff(frame, 16)):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["native", "approx"])
@pytest.mark.parametrize("kind", KINDS)
def test_pesq_and_composite_equal(kind, mode, monkeypatch):
    monkeypatch.setenv("SEGAN_TPU_PESQ", mode)
    ref, deg = _signals(kind)
    got, want = tm.PESQ(ref, deg), jm.PESQ(ref, deg)
    assert got is not None and np.isfinite(got)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(tm.CompositeEval(ref, deg, log_all=True),
                               jm.CompositeEval(ref, deg, log_all=True), **TOL)


def test_eval_composite_with_the_noisy_baseline(monkeypatch):
    """What a worker of the evaluation pool returns for one utterance."""
    monkeypatch.setenv("SEGAN_TPU_PESQ", "approx")
    ref, deg = _signals("noise")
    _, noisy = _signals("delay", seed=1)
    got = tm.composite_helper((ref, deg, noisy))
    want = jm.composite_helper((ref, deg, noisy))
    for g, w in zip(got, want):
        assert list(g) == ["csig", "cbak", "covl", "pesq", "ssnr"] == list(w)
        np.testing.assert_allclose([g[k] for k in g], [w[k] for k in w], **TOL)


def test_native_pesq_library_is_the_same_build():
    if jpn.get_lib() is None:
        pytest.skip("the JAX package's native library did not build")
    assert tpn.get_lib() is not None
    assert tpn.pesq_compiled_constants() == jpn.pesq_compiled_constants()
    for fs in (8000, 16000):
        got, want = tpn.pesq_compiled_tables(fs), jpn.pesq_compiled_tables(fs)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    ref, deg = _signals("noise")
    assert tpn.pesq_native(ref, deg, return_raw=True) == jpn.pesq_native(ref, deg,
                                                                         return_raw=True)
