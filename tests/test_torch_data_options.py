"""The port's data options of ``train.py`` against the JAX package's, batch for batch and
bit for bit on one synthetic corpus (the one of ``tests/test_torch_data.py``, 41 slices):
``--random_scale`` and ``--preemph_norm`` in ``SEDataset``, the streaming shuffle
buffer (``--shuffle_buffer``, both modes) and the cast at collate time
(``--loader_dtype``, with torch in place of ``ml_dtypes``) in ``DataLoader``,
``device_prefetch`` keeping the cast dtype, and ``SEH5Dataset`` with the port's
``tools/make_h5.py`` against the repo's. Every loader runs one worker: both packages
draw ``random_scale`` from the module-level ``random``, which is seeded before each
side's epochs, so thread order would change the draws."""
import importlib.util
import random
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from segan_pytorch_tpu.data import DataLoader as JaxLoader, SEDataset as JaxDataset
from segan_pytorch_tpu.data import SEH5Dataset as JaxH5Dataset
from segan_pytorch_tpu.data import native as jax_native
from segan_pytorch_tpu_torch.data import native
from segan_pytorch_tpu_torch.data.loader import (DataLoader, device_prefetch, host_float32,
                                                 loader_dtype)
from segan_pytorch_tpu_torch.data.se_dataset import SEDataset, SEH5Dataset
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.tools import make_h5
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import SLICE, write_pairs

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("clean", "noisy", "mask", "uttname", "slice_idx")
SCALES = [0.5, 1, 2]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_pairs(tmp_path_factory.mktemp("corpus"),
                       [24000, 20000, 18000, 9000, 16500, 5000, 12288])


def _pair(corpus, tmp_path, **kw):
    j = JaxDataset(*corpus, 0.95, cache_dir=str(tmp_path / "j"), slice_size=SLICE,
                   slice_workers=1, **kw)
    t = SEDataset(*corpus, 0.95, cache_dir=str(tmp_path / "t"), slice_size=SLICE,
                  slice_workers=1, **kw)
    return j, t


def _epochs(loader, n, seed=3):
    """n epochs of `loader`, with the module-level random seeded first."""
    random.seed(seed)
    return [list(loader) for _ in range(n)]


def _assert_equal(jb, tb, keys=KEYS):
    for k in keys:
        assert np.array_equal(np.asarray(jb[k]), np.asarray(tb[k])), k


@pytest.mark.parametrize("opts", [dict(random_scale=SCALES), dict(preemph_norm=True),
                                  dict(random_scale=SCALES, preemph_norm=True)],
                         ids=["random_scale", "preemph_norm", "both"])
def test_dataset_options_give_the_jax_batches(corpus, tmp_path, opts):
    """Two shuffled epochs of batches of 12 (the last ragged) on the Python path, which
    both packages take for these options: the same bytes, scaled rows among them."""
    j, t = _pair(corpus, tmp_path, **opts)
    assert t.gather_batch([0, 1]) is None and j.gather_batch([0, 1]) is None
    jl = JaxLoader(j, batch_size=12, shuffle=True, num_workers=1, seed=7)
    tl = DataLoader(t, batch_size=12, shuffle=True, num_workers=1, seed=7)
    want, got = _epochs(jl, 2), _epochs(tl, 2)
    for je, te in zip(want, got):
        assert len(je) == len(te) == 4
        for jb, tb in zip(je, te):
            _assert_equal(jb, tb)
    if opts == dict(random_scale=SCALES):  # rows scaled as a whole, by several scales
        plain = SEDataset(*corpus, 0.95, cache_dir=str(tmp_path / "t"), slice_size=SLICE)
        ratios = {round(float(np.abs(t[i]["clean"]).max() / np.abs(plain[i]["clean"]).max()),
                        4) for i in range(12)}
        assert ratios <= {0.5, 1.0, 2.0} and len(ratios) > 1, ratios


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("mode", ["sharded", "global"])
def test_shuffle_buffer_gives_the_jax_batches(corpus, tmp_path, mode, shuffle):
    """A buffer of 16 slices, batches of 8 over 41 slices: 5 batches an epoch, the tail
    of one slice dropped, masks of ones; two epochs (each draws a new stream)."""
    j, t = _pair(corpus, tmp_path)
    kw = dict(batch_size=8, shuffle=shuffle, num_workers=1, seed=11, shuffle_buffer=16,
              shuffle_buffer_mode=mode)
    jl, tl = JaxLoader(j, **kw), DataLoader(t, **kw)
    assert len(tl) == len(jl) == 41 // 8
    want, got = _epochs(jl, 2), _epochs(tl, 2)
    rows = []
    for je, te in zip(want, got):
        assert len(je) == len(te) == 5
        for jb, tb in zip(je, te):
            _assert_equal(jb, tb)
            assert tb["mask"].dtype == np.float32 and (tb["mask"] == 1).all()
        rows.append([u for b in te for u in zip(b["uttname"], b["slice_idx"])])
    assert len(set(rows[0])) == 40
    assert (rows[0] != rows[1]) == shuffle  # FIFO without shuffle: the same walk


def test_shuffle_buffer_mode_is_checked(corpus, tmp_path):
    _, t = _pair(corpus, tmp_path)
    with pytest.raises(ValueError, match="shuffle_buffer_mode"):
        DataLoader(t, batch_size=8, shuffle_buffer=4, shuffle_buffer_mode="local")


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_loader_dtype_casts_like_ml_dtypes(corpus, tmp_path, name):
    """The cast batches equal the JAX loader's ml_dtypes ones bit for bit (the ragged
    batch's padding rows too), the mask stays fp32, and device_prefetch on the CPU keeps
    the dtype and the bytes; host_float32 gives the exact up-cast."""
    j, t = _pair(corpus, tmp_path, random_scale=SCALES)
    jl = JaxLoader(j, batch_size=12, shuffle=True, num_workers=1, seed=5, emit_dtype=name)
    tl = DataLoader(t, batch_size=12, shuffle=True, num_workers=1, seed=5, emit_dtype=name)
    (want,), (got,) = _epochs(jl, 1), _epochs(tl, 1)
    dtype = getattr(torch, name)
    for jb, tb in zip(want, got):
        for k in ("clean", "noisy"):
            assert tb[k].dtype == dtype and jb[k].dtype == np.dtype(
                ml_dtypes.bfloat16 if name == "bfloat16" else np.float16)
            assert np.array_equal(tb[k].view(torch.int16).numpy(), jb[k].view(np.int16))
            np.testing.assert_array_equal(host_float32(tb[k]), jb[k].astype(np.float32))
        _assert_equal(jb, tb, ("mask", "uttname", "slice_idx"))
        assert tb["mask"].dtype == np.float32
    tl = DataLoader(t, batch_size=12, shuffle=True, num_workers=1, seed=5, emit_dtype=name)
    random.seed(3)
    staged = list(device_prefetch(iter(tl), "cpu"))
    for g, w in zip(staged, got):
        for k in ("clean", "noisy"):
            assert g[k].dtype == dtype and torch.equal(g[k], w[k])
            assert g["host"][k] is g[k] or torch.equal(g["host"][k], g[k])
        assert g["mask"].dtype == torch.float32


def test_an_fp32_step_sees_the_jax_bf16_inputs(corpus, tmp_path):
    """The step's up-cast of a bf16 batch on the device equals the JAX step's input,
    ml_dtypes' round to nearest even of the same fp32 values, made fp32 again."""
    j, t = _pair(corpus, tmp_path)
    jb = next(iter(JaxLoader(j, batch_size=12, shuffle=False, emit_dtype="bfloat16")))
    tb = next(iter(DataLoader(t, batch_size=12, shuffle=False, emit_dtype="bfloat16")))
    seg = SEGAN(SEGANConfig(slice_size=SLICE, genc_fmaps=[8, 16], genc_poolings=[4, 4],
                            z_dim=16), device="cpu")
    x = seg._inputs(tb["clean"][..., None], tb["noisy"][..., None], tb["mask"])
    assert x["clean"].dtype == torch.float32
    np.testing.assert_array_equal(x["clean"][..., 0].numpy(), jb["clean"].astype(np.float32))
    np.testing.assert_array_equal(x["noisy"][..., 0].numpy(), jb["noisy"].astype(np.float32))


@pytest.mark.parametrize("name", ["int16", "bfloat17", "complex64"])
def test_a_dtype_the_port_cannot_cast_raises(corpus, tmp_path, name):
    _, t = _pair(corpus, tmp_path)
    with pytest.raises(TypeError, match=name):
        DataLoader(t, batch_size=4, emit_dtype=name)
    assert loader_dtype("bfloat16") is torch.bfloat16


def _jax_make_h5(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_make_h5", ROOT / "tools" / "make_h5.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["make_h5.py"] + argv)
    mod.main()


@pytest.fixture(scope="module")
def h5_files(corpus, tmp_path_factory):
    """train.h5 from the repo's tool and from the port's, both on the Python gather (the
    native one differs from it by an ulp in both packages)."""
    root = tmp_path_factory.mktemp("h5")
    # the slice index cached first: the repo's tool would slice in a forked pool
    JaxDataset(*corpus, 0.95, cache_dir=str(root / "jcache"), slice_size=SLICE,
               slice_workers=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "NativeAudioEngine", None)
        mp.setattr(native, "NativeAudioEngine", None)
        argv = ["--clean_dir", corpus[0], "--noisy_dir", corpus[1], "--split", "train",
                "--slice_size", str(SLICE)]
        _jax_make_h5(argv + ["--out_dir", str(root / "j"), "--cache_dir",
                             str(root / "jcache")], mp)
        path = make_h5.main(argv + ["--out_dir", str(root / "t")])
    assert path == str(root / "t" / "train.h5")
    return root


def test_make_h5_writes_the_jax_tool_s_arrays(h5_files, corpus, tmp_path):
    import h5py

    with h5py.File(h5_files / "j" / "train.h5", "r") as fj, \
            h5py.File(h5_files / "t" / "train.h5", "r") as ft:
        assert set(ft.keys()) == set(fj.keys()) == {"data", "label"}
        for k in ("data", "label"):
            assert ft[k].shape == fj[k].shape == (41, SLICE, 1)
            assert ft[k].dtype == fj[k].dtype == np.float32
            assert np.array_equal(ft[k][()], fj[k][()]), k
        # the slices of SEDataset in index order: clean under 'data', noisy under 'label'
        t = SEDataset(*corpus, 0.95, cache_dir=str(tmp_path), slice_size=SLICE)
        t._native = False
        for i in (0, 17, 40):
            assert np.array_equal(ft["data"][i, :, 0], t[i]["clean"])
            assert np.array_equal(ft["label"][i, :, 0], t[i]["noisy"])


def test_h5_dataset_gives_the_jax_items_and_batches(h5_files):
    root = str(h5_files / "t")
    j = JaxH5Dataset(root, "train", 0.95, random_scale=SCALES)
    t = SEH5Dataset(root, "train", 0.95, random_scale=SCALES)
    assert len(t) == len(j) == 41
    random.seed(4)
    want = [j[i] for i in range(41)]
    random.seed(4)
    got = [t[i] for i in range(41)]
    for a, b in zip(want, got):
        assert set(a) == set(b) and b["uttname"] == "N/A" and b["clean"].shape == (SLICE,)
        for k in ("clean", "noisy"):
            assert b[k].dtype == np.float32 and np.array_equal(a[k], b[k])
    jl = JaxLoader(j, batch_size=12, shuffle=True, num_workers=1, seed=2)
    tl = DataLoader(t, batch_size=12, shuffle=True, num_workers=1, seed=2)
    for jb, tb in zip(*(e[0] for e in (_epochs(jl, 1), _epochs(tl, 1)))):
        _assert_equal(jb, tb)
    with pytest.raises(FileNotFoundError):
        SEH5Dataset(root, "valid", 0.95)


def test_a_missing_h5py_raises_with_its_name(h5_files, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        SEH5Dataset(str(h5_files / "t"), "train", 0.95)
    with pytest.raises(ImportError, match="h5py"):
        make_h5.main(["--clean_dir", "c", "--noisy_dir", "n", "--out_dir", "o"])
