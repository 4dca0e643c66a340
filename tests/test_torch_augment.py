"""The port's additive-noise augmentation (``data/augment.py``, ``--noises_dir`` /
``--snr_levels``) against the JAX package's: ``Additive`` bit for bit for one
``RandomState`` seed over several SNRs and a level that clips, its P.56 level and
interpolation, the dataset's transform path batch for batch (the native gather skipped
as in JAX), the refusal of a transform with ``preemph_norm``, and WSEGAN's additive L1
term switched on by the '_additive' names."""
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from segan_pytorch_tpu.data import DataLoader as JaxLoader, SEDataset as JaxDataset
from segan_pytorch_tpu.data.augment import Additive as JaxAdditive
from segan_pytorch_tpu_torch.data.augment import Additive
from segan_pytorch_tpu_torch.data.loader import DataLoader
from segan_pytorch_tpu_torch.data.se_dataset import SEDataset
from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import SLICE, write_pairs


def write_noises(root: Path, n_files: int = 3, n: int = 20000, seed: int = 0) -> str:
    """int16 16 kHz noise wavs longer than a slice: white, a hum and babble-like
    bursts. Returns the directory."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    t = np.arange(n) / 16000.0
    kinds = [rng.randn(n) * 0.2,
             0.3 * np.sin(2 * np.pi * 50 * t) + 0.05 * rng.randn(n),
             rng.randn(n) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) * 0.3]
    for i in range(n_files):
        wavfile.write(str(root / f"noise{i}.wav"), 16000,
                      np.clip(kinds[i % 3] * 32767, -32768, 32767).astype(np.int16))
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug")
    pairs = write_pairs(root / "pairs", [24000, 20000, 18000, 9000, 16500, 5000, 12288])
    return pairs, write_noises(root / "noises")


def _speech(n, seed):
    """A normalized syllable-like signal with pauses, as the dataset's clean slices are."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    x = np.sin(2 * np.pi * rng.uniform(100, 250) * t) * (np.sin(2 * np.pi * 3 * t) > 0)
    x = x + 0.01 * rng.randn(n)
    return (x / np.abs(x).max()).astype(np.float32)


@pytest.mark.parametrize("snrs", [[0, 5, 10], [-5, 15, 20], [-25]],
                         ids=["default", "wide", "clips"])
def test_additive_equals_the_jax_one(corpus, snrs):
    """Twelve slices at a peak of 0.3 through both, each with a RandomState(9): the same
    noisy bytes and the same generator state after; at -25 dB every sum clips and the
    anti-clipping renorm runs, at the other levels only some do."""
    noises = corpus[1]
    j = JaxAdditive(noises, snrs, rng=np.random.RandomState(9))
    t = Additive(noises, snrs, rng=np.random.RandomState(9))
    assert [n["file"] for n in t.noises] == [n["file"] for n in j.noises]
    # a third copy in step with them, to see the sum before the renorm
    probe = Additive(noises, snrs, rng=np.random.RandomState(9))
    clipped = 0
    for i in range(12):
        x = 0.3 * _speech(SLICE, i)
        want, got = j(x), t(x)
        assert got.dtype == np.float32 and np.array_equal(got, want), i
        assert np.abs(got).max() < 1 or got.min() == -1
        noise = probe.noises[int(probe.rng.choice(len(probe.noises)))]["data"]
        raw, _ = probe.addnoise_asl(x, noise, 16000, 16, float(probe.rng.choice(snrs)))
        clipped += int(raw.max() >= 1 or raw.min() < -1)
    assert np.array_equal(t.rng.get_state()[1], j.rng.get_state()[1])
    assert np.array_equal(probe.rng.get_state()[1], j.rng.get_state()[1])
    assert clipped == 12 if snrs == [-25] else clipped < 12, clipped


def test_p56_level_and_interpolation_equal(corpus):
    j = JaxAdditive(corpus[1], rng=np.random.RandomState(0))
    t = Additive(corpus[1], rng=np.random.RandomState(0))
    for i, scale in enumerate((1.0, 0.1, 1e-3, 0.0)):
        x = _speech(8000, 20 + i) * scale
        assert t.asl_P56(x, 16000, 16) == j.asl_P56(x, 16000, 16), scale
    for args in ((40.0, 35.0, -20.0, -26.0, 15.9, 0.5), (10.0, 9.0, -80.0, -86.0, 15.9, 0.5)):
        assert t.bin_interp(*args) == j.bin_interp(*args)
    with pytest.raises(ValueError, match="No noises"):
        Additive(str(Path(corpus[1]).parent / "pairs"), rng=np.random.RandomState(0))
    with pytest.raises(ValueError, match="greater than speech"):
        t.addnoise_asl(_speech(30000, 1), t.noises[0]["data"], 16000, 16, 5.0)


def test_transform_batches_equal_the_jax_ones(corpus):
    """Two shuffled epochs of batches of 12 with noisy made anew from the clean slice:
    the same bytes and '_additive' names; no native gather on either side."""
    pairs, noises = corpus
    root = Path(noises).parent
    j = JaxDataset(*pairs, 0.95, cache_dir=str(root / "j"), slice_size=SLICE,
                   slice_workers=1, transform=JaxAdditive(noises, [0, 5, 10],
                                                          rng=np.random.RandomState(4)))
    t = SEDataset(*pairs, 0.95, cache_dir=str(root / "t"), slice_size=SLICE,
                  slice_workers=1, transform=Additive(noises, [0, 5, 10],
                                                      rng=np.random.RandomState(4)))
    assert t.gather_batch([0, 1]) is None and j.gather_batch([0, 1]) is None
    jl = JaxLoader(j, batch_size=12, shuffle=True, num_workers=1, seed=6)
    tl = DataLoader(t, batch_size=12, shuffle=True, num_workers=1, seed=6)
    plain = SEDataset(*pairs, 0.95, cache_dir=str(root / "t"), slice_size=SLICE)
    for epoch in range(2):
        random.seed(epoch)
        want = list(jl)
        random.seed(epoch)
        got = list(tl)
        assert len(want) == len(got) == 4
        for jb, tb in zip(want, got):
            for k in ("clean", "noisy", "mask", "uttname", "slice_idx"):
                assert np.array_equal(np.asarray(jb[k]), np.asarray(tb[k])), k
            assert all(u.endswith("_additive") for u in tb["uttname"])
    # clean is the plain path's slice (but its first sample, which the slice's own
    # pre-emphasis leaves as it is); noisy is not the recorded noisy wav
    item, ref = t[3], plain[3]
    np.testing.assert_allclose(item["clean"][1:], ref["clean"][1:], rtol=0, atol=2e-7)
    assert np.abs(item["noisy"] - ref["noisy"]).max() > 1e-2


def test_a_transform_with_preemph_norm_is_refused(corpus):
    pairs, noises = corpus
    root = Path(noises).parent
    for ds, add in ((JaxDataset, JaxAdditive), (SEDataset, Additive)):
        with pytest.raises(ValueError, match="preemph_norm"):
            ds(*pairs, 0.95, cache_dir=str(root / "c"), slice_size=SLICE,
               preemph_norm=True, transform=add(noises, rng=np.random.RandomState(0)))


def test_wsegan_takes_the_additive_l1_term_on_augmented_batches(corpus):
    """WSEGAN's loop marks every augmented row additive, and a step on such a batch has a
    nonzero additive L1 term (den_loss), which the plain batch's names leave at 0."""
    pairs, noises = corpus
    root = Path(noises).parent
    cfg = SEGANConfig(slice_size=SLICE, genc_fmaps=[8, 16], genc_poolings=[4, 4], z_dim=16,
                      denc_fmaps=[8, 16], denc_poolings=[4, 4], dpool_slen=256, wsegan=True,
                      gnorm_type="snorm", dnorm_type="snorm", opt="adam",
                      misalign_pair=True, batch_size=4)
    seg = WSEGAN(cfg, device="cpu")
    dens = {}
    for name, transform in (("plain", None),
                            ("additive", Additive(noises, rng=np.random.RandomState(1)))):
        t = SEDataset(*pairs, 0.95, cache_dir=str(root / "w"), slice_size=SLICE,
                      slice_workers=1, transform=transform)
        batch = next(seg._batches(DataLoader(t, batch_size=4, seed=2), with_additive=True))
        amask = batch["additive_mask"]
        assert amask.dtype == torch.float32
        assert torch.equal(amask, torch.full((4,), float(name == "additive")))
        m, _, _ = seg.train_step(batch["clean"][..., None], batch["noisy"][..., None],
                                 batch["mask"], amask, 100.0)
        dens[name] = float(m["den_loss"])
    assert dens["plain"] == 0.0 and dens["additive"] > 0, dens
