"""The port's data pipeline (``data/se_dataset.py``, ``data/loader.py``, ``data/native.py``)
against the JAX package's on one synthetic corpus: the same slice index, and every batch
equal bit for bit on both gather paths, with one and two worker threads, shuffled, with a
ragged final batch. Also ``device_prefetch`` and where the C++ library is built."""
from pathlib import Path

import numpy as np
import pytest
import torch

from segan_pytorch_tpu.data import DataLoader as JaxLoader, SEDataset as JaxDataset
from segan_pytorch_tpu.data import native as jax_native
from segan_pytorch_tpu_torch.data import native
from segan_pytorch_tpu_torch.data.loader import DataLoader, device_prefetch
from segan_pytorch_tpu_torch.data.se_dataset import SEDataset
from segan_pytorch_tpu_torch.ops.kernels import build

ROOT = Path(__file__).resolve().parents[1]
SLICE = 4096
KEYS = ("clean", "noisy", "mask", "uttname", "slice_idx")


def write_pairs(root: Path, lengths, seed: int = 0):
    """Paired int16 16 kHz wavs under root/clean and root/noisy: a tone per utterance,
    and the noisy one with white noise added. Returns the two directories."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    dirs = []
    for sub in ("clean", "noisy"):
        (root / sub).mkdir(parents=True)
        dirs.append(str(root / sub))
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        c = 0.3 * np.sin(2 * np.pi * (200 + 37 * i) * t) + 0.1 * np.sin(2 * np.pi * 90 * t)
        noisy = c + 0.05 * rng.randn(n)
        wavfile.write(str(root / "clean" / f"utt{i}.wav"), 16000,
                      (c * 32767).astype(np.int16))
        wavfile.write(str(root / "noisy" / f"utt{i}.wav"), 16000,
                      np.clip(noisy * 32767, -32768, 32767).astype(np.int16))
    return dirs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    # 41 slices at stride 0.5: batches of 12 leave a ragged final batch of 5
    return write_pairs(tmp_path_factory.mktemp("corpus"),
                       [24000, 20000, 18000, 9000, 16500, 5000, 12288])


def _datasets(corpus, tmp_path):
    clean, noisy = corpus
    j = JaxDataset(clean, noisy, 0.95, cache_dir=str(tmp_path / "j"), slice_size=SLICE,
                   slice_workers=1)
    t = SEDataset(clean, noisy, 0.95, cache_dir=str(tmp_path / "t"), slice_size=SLICE,
                  slice_workers=1)
    return j, t


def test_slice_index_equal_and_cache_shared(corpus, tmp_path):
    j, t = _datasets(corpus, tmp_path)
    assert len(t) == 41 and t.idx2slice == j.idx2slice
    # the port reads the JAX package's cache file, and writes the same one
    again = SEDataset(*corpus, 0.95, cache_dir=str(tmp_path / "j"), slice_size=SLICE)
    assert again.idx2slice == j.idx2slice
    assert (tmp_path / "t" / "train_idx2slice.json").read_text() == (
        tmp_path / "j" / "train_idx2slice.json").read_text()


@pytest.mark.parametrize("num_workers", [1, 2])
@pytest.mark.parametrize("path", ["native", "python"])
def test_batches_equal_the_jax_loader(corpus, tmp_path, path, num_workers):
    """Three shuffled epochs of batches of 12 (the last one ragged: 5 rows, then 7 copies
    of the fifth with mask 0)."""
    j, t = _datasets(corpus, tmp_path)
    if path == "python":
        j._native = t._native = False
    jl = JaxLoader(j, batch_size=12, shuffle=True, num_workers=num_workers, seed=7)
    tl = DataLoader(t, batch_size=12, shuffle=True, num_workers=num_workers, seed=7)
    assert len(tl) == len(jl) == 4
    for _ in range(3):
        batches = list(zip(jl, tl))
        assert len(batches) == 4
        for jb, tb in batches:
            for k in KEYS:
                assert np.array_equal(np.asarray(jb[k]), np.asarray(tb[k])), k
        assert list(tb["mask"]) == [1] * 5 + [0] * 7
        assert tb["uttname"][5:] == [tb["uttname"][4]] * 7
    assert (t._native not in (None, False)) == (path == "native")


def test_native_and_python_paths_agree(corpus, tmp_path):
    """Both gather paths of the port give the same slices (float sums in another order
    at most one ulp apart, as in the JAX package)."""
    _, t = _datasets(corpus, tmp_path)
    rows = list(range(len(t)))
    fast = t.gather_batch(rows)
    assert fast is not None
    t._native = False
    assert t.gather_batch(rows) is None
    slow = DataLoader(t, batch_size=len(t), shuffle=False)._make_batch(rows)
    for k in ("clean", "noisy"):
        np.testing.assert_allclose(fast[k], slow[k], rtol=0, atol=2e-7)
    assert fast["uttname"] == slow["uttname"]
    assert np.array_equal(fast["slice_idx"], slow["slice_idx"])


def test_early_abandon_stops_the_workers(corpus, tmp_path):
    _, t = _datasets(corpus, tmp_path)
    it = iter(DataLoader(t, batch_size=2, shuffle=False, num_workers=2, prefetch=1))
    first = next(it)
    it.close()  # the consumer leaves after one batch, as evaluate() does
    assert first["clean"].shape == (2, SLICE)


def test_device_prefetch_stages_the_batch(corpus, tmp_path):
    _, t = _datasets(corpus, tmp_path)
    loader = DataLoader(t, batch_size=12, shuffle=True, seed=1)
    want = list(DataLoader(t, batch_size=12, shuffle=True, seed=1))
    got = list(device_prefetch(iter(loader), "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("clean", "noisy", "mask"):
            assert torch.is_tensor(g[k]) and g[k].dtype == torch.float32
            assert np.array_equal(g[k].numpy(), w[k])
        assert g["uttname"] == w["uttname"] and g["host"]["uttname"] == w["uttname"]
    # a batch without a mask passes through without one
    (only,) = device_prefetch(iter([{"clean": want[0]["clean"]}]), "cpu")
    assert set(only) == {"clean", "host"}


def test_native_engine_reads_like_the_jax_one(corpus):
    if not jax_native.available():
        pytest.skip("the JAX package's native library did not build")
    path = str(Path(corpus[1]) / "utt0.wav")
    got = native.NativeAudioEngine(threads=2).read(path, 0.95)
    assert np.array_equal(got, jax_native.NativeAudioEngine(threads=2).read(path, 0.95))


def test_host_libraries_build_beside_the_kernels_not_into_native():
    for name in ("segan_io", "pesq862"):
        out = build.host_library_path(name)
        assert out.parent == ROOT / "build" / "torch_native"
        assert out.name.startswith(f"lib{name}-") and out.suffix == ".so"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    src = (ROOT / "segan_pytorch_tpu_torch" / "data" / "native.py").read_text()
    assert "segan_pytorch_tpu." not in src and "make" not in src.split()
