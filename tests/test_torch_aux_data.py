"""The port's copies of the other datasets and metrics against the JAX package's
originals: the random-chunk datasets (``data/se_dataset.py``: ``RandomChunkSEDataset``
with its short-utterance zero pad and speaker ids, ``RandomChunkSEF0Dataset``) bit for
bit under the same ``random.seed``; ``data/vc_dataset.py``; ``data/aco.py`` (file I/O,
interpolation, the autocorrelation tracker, ``wav2lf0`` without the ``ahocoder16_64``
binary); ``metrics/f0.py`` (``F0Evaluator`` also on a spawned pool of two) and
``metrics/stoi.py`` to 1e-9."""
import importlib
import random

import numpy as np
import pytest
from scipy.io import wavfile

from segan_pytorch_tpu.data import aco as jaco
from segan_pytorch_tpu.data import se_dataset as jse
from segan_pytorch_tpu.data import vc_dataset as jvc
from segan_pytorch_tpu.metrics import f0 as jf0
from segan_pytorch_tpu_torch.data import aco as taco
from segan_pytorch_tpu_torch.data import se_dataset as tse
from segan_pytorch_tpu_torch.data import vc_dataset as tvc
from segan_pytorch_tpu_torch.metrics import f0 as tf0

# the packages' metrics/__init__.py export the function stoi under the module's name
jstoi = importlib.import_module("segan_pytorch_tpu.metrics.stoi")
tstoi = importlib.import_module("segan_pytorch_tpu_torch.metrics.stoi")

TOL = dict(rtol=1e-9, atol=1e-12)
SLICE = 4096
# utterance lengths: one shorter than the slice (zero-padded), one exactly a slice
LENGTHS = [9000, 2500, 4096, 12345]


def _speech(n, seed):
    """A voiced-like tone complex at a drifting pitch, with a pause, in [-1, 1]."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t + seed)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    x = sum(a * np.sin(k * phase) for k, a in ((1, 0.4), (2, 0.2), (3, 0.1)))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t)) + 0.01 * rng.randn(n)
    x[n // 3: n // 3 + n // 10] *= 0.001
    return np.clip(x, -1, 1)


def _pcm(x):
    return (x * 30000).astype(np.int16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """clean/, noisy/ (noisy = clean + noise, the same names), lf0/ (one .lf0 per clean
    wav: 80-sample frames, every fifth unvoiced at -1e10) and utt2spk."""
    root = tmp_path_factory.mktemp("aux_corpus")
    rng = np.random.RandomState(0)
    for d in ("clean", "noisy", "lf0"):
        (root / d).mkdir()
    lines = []
    for i, n in enumerate(LENGTHS):
        x = _speech(n, i)
        wavfile.write(str(root / "clean" / f"u{i}.wav"), 16000, _pcm(x))
        wavfile.write(str(root / "noisy" / f"u{i}.wav"), 16000,
                      _pcm(np.clip(x + 0.05 * rng.randn(n), -1, 1)))
        lf0 = np.log(100 + 50 * rng.rand(n // 80)).astype(np.float32)
        lf0[::5] = -1e10
        taco.write_aco_file(str(root / "lf0" / f"u{i}.lf0"), lf0)
        lines.append(f"u{i}.wav\tspk{i % 2}")
    (root / "utt2spk").write_text("\n".join(lines) + "\n")
    return root


def _epochs(ds, seed, n_epochs=3):
    random.seed(seed)
    return [ds[i] for _ in range(n_epochs) for i in range(len(ds))]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("speakers", [False, True])
def test_random_chunk_dataset_equals_jax(corpus, speakers):
    kw = {}
    if speakers:
        kw = dict(utt2spk=str(corpus / "utt2spk"), spk2idx={"spk0": 0, "spk1": 1})
    args = (str(corpus / "clean"), str(corpus / "noisy"), 0.95)
    t_ds = tse.RandomChunkSEDataset(*args, slice_size=SLICE, **kw)
    j_ds = jse.RandomChunkSEDataset(*args, slice_size=SLICE, **kw)
    got, want = _epochs(t_ds, 7), _epochs(j_ds, 7)
    _assert_items_equal(got, want)
    short = [g for g in got if g["uttname"] == "u1"]
    assert all(np.all(g["clean"][2500:] == 0) and g["clean"].shape == (SLICE,)
               for g in short)
    assert len({g["clean"][:8].tobytes() for g in got if g["uttname"] == "u3"}) > 1
    assert ("spkid" in got[0]) == speakers
    if speakers:
        assert [g["spkid"] for g in got[:4]] == [0, 1, 0, 1]


def test_random_chunk_dataset_needs_spk2idx(corpus):
    with pytest.raises(ValueError, match="spk2idx"):
        tse.RandomChunkSEDataset(str(corpus / "clean"), str(corpus / "noisy"), 0.95,
                                 utt2spk=str(corpus / "utt2spk"))


@pytest.mark.parametrize("preemph", [0.0, 0.95])
def test_random_chunk_f0_dataset_equals_jax(corpus, preemph):
    args = (str(corpus / "clean"), str(corpus / "lf0"), preemph)
    got = _epochs(tse.RandomChunkSEF0Dataset(*args, slice_size=SLICE), 3)
    want = _epochs(jse.RandomChunkSEF0Dataset(*args, slice_size=SLICE), 3)
    _assert_items_equal(got, want)
    assert got[0]["lf0"].shape == got[0]["uv"].shape == (SLICE // 80 + 1,)
    assert 0 < float(np.mean([g["uv"].mean() for g in got])) < 1


def test_vc_dataset_and_collate_equal_jax(corpus):
    t_ds = tvc.VCDataset(str(corpus / "clean"), str(corpus / "noisy"), preemph=0.95)
    j_ds = jvc.VCDataset(str(corpus / "clean"), str(corpus / "noisy"), preemph=0.95)
    assert len(t_ds) == len(j_ds) == len(LENGTHS)
    items, j_items = [t_ds[i] for i in range(len(t_ds))], [j_ds[i] for i in range(len(j_ds))]
    for (s, t), (sj, tj) in zip(items, j_items):
        assert np.array_equal(s, sj) and np.array_equal(t, tj)
    named = [("n", s, t) for s, t in items[:2]] + items[2:]
    got, want = tvc.varlen_wav_collate(named), jvc.varlen_wav_collate(named)
    assert got[0] == want[0] == ""
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
    assert got[1].shape == (4, max(LENGTHS))


def test_aco_round_trip_and_interpolation(tmp_path):
    rng = np.random.RandomState(3)
    data = rng.randn(7, 5).astype(np.float32)
    taco.write_aco_file(str(tmp_path / "t.aco"), data)
    jaco.write_aco_file(str(tmp_path / "j.aco"), data)
    assert (tmp_path / "t.aco").read_bytes() == (tmp_path / "j.aco").read_bytes()
    assert np.array_equal(taco.read_aco_file(str(tmp_path / "t.aco"), (7, 5)), data)
    assert np.array_equal(taco.read_aco_file(str(tmp_path / "t.aco")), data.reshape(-1))
    sig = rng.rand(40).astype(np.float32) + 4
    sig[[0, 1, 7, 8, 9, 39]] = -1e10
    for s, sym in ((sig, -1e10), (np.where(sig < 0, 0.0, sig), 0.0),
                   (np.full(6, -1e10, np.float32), -1e10)):
        for g, w in zip(taco.interpolation(s, sym), jaco.interpolation(s, sym)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    ilf0, uv = taco.interpolation(sig, -1e10)
    assert ilf0[0] == ilf0[2] and uv.sum() == 34


def test_f0_tracker_and_wav2lf0_equal_jax(monkeypatch):
    """The autocorrelation tracker; wav2lf0 without the ahocoder16_64 binary, which both
    packages then replace by that tracker."""
    for mod in (taco, jaco):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
    x = _speech(16000, 4).astype(np.float32)
    for args in ((x,), (x[:200],), (x, 16000, 160, 400)):
        for g, w in zip(taco.f0_autocorr(*args), jaco.f0_autocorr(*args)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    (ilf0, uv), (ilf0_j, uv_j) = taco.wav2lf0(x), jaco.wav2lf0(x)
    assert np.array_equal(ilf0, ilf0_j) and np.array_equal(uv, uv_j)
    assert 0.2 < uv.mean() < 1 and np.isfinite(ilf0).all()


def test_f0_measures_equal_jax():
    rng = np.random.RandomState(5)
    a, b = rng.rand(3, 50) + 4, rng.rand(3, 50) + 4
    mask = (rng.rand(3, 48) > 0.3).astype(np.float32)
    np.testing.assert_allclose(tf0.KLD(a.mean(1), a.std(1), b.mean(1), b.std(1)),
                               jf0.KLD(a.mean(1), a.std(1), b.mean(1), b.std(1)), **TOL)
    np.testing.assert_allclose(tf0.compute_MAE(a, b, mask), jf0.compute_MAE(a, b, mask),
                               **TOL)
    uv, ref = rng.rand(3, 50) > 0.5, rng.rand(3, 47) > 0.5
    np.testing.assert_allclose(tf0.compute_accuracy(uv, ref),
                               jf0.compute_accuracy(uv, ref), **TOL)


@pytest.mark.parametrize("num_proc", [1, 2])
def test_f0_evaluator_equals_jax(num_proc, monkeypatch):
    """num_proc 2 runs the tracker on a spawned pool, which the test ends."""
    for mod in (taco, jaco):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
    wavs = np.stack([_speech(16000, s) for s in (1, 2)]).astype(np.float32)
    refs = np.stack([_speech(16000, s) for s in (3, 2)]).astype(np.float32)
    ev = tf0.F0Evaluator(num_proc=num_proc)
    try:
        got = ev(wavs, refs)
    finally:
        if ev.pool is not None:
            ev.pool.terminate()
    assert (ev.pool is not None) == (num_proc > 1)
    want = jf0.F0Evaluator(num_proc=1)(wavs, refs)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    assert got[2][1] == 1 and got[1][1] == 0  # a wav against itself


def test_f0_evaluator_refuses_preloaded_gtruth():
    with pytest.raises(NotImplementedError):
        tf0.F0Evaluator("some_dir")


@pytest.mark.parametrize("kind", ["noise", "short", "delay"])
def test_stoi_and_band_profile_equal_jax(kind):
    rng = np.random.RandomState(6)
    n = {"noise": 48000, "short": 9000, "delay": 32000}[kind]
    ref = _speech(n, 8)
    deg = ref + 0.1 * rng.randn(n)
    if kind == "delay":
        deg = np.concatenate([np.zeros(80), deg[:-80]])
    np.testing.assert_allclose(tstoi.stoi(ref, deg, 16000), jstoi.stoi(ref, deg, 16000),
                               **TOL)
    for g, w in zip(tstoi.stoi_band_profile(ref, deg, dyn_range=25),
                    jstoi.stoi_band_profile(ref, deg, dyn_range=25)):
        np.testing.assert_allclose(g, w, **TOL)
    assert 0 < tstoi.stoi(ref, deg) < 1
