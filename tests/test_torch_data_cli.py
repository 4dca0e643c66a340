"""``python -m segan_pytorch_tpu_torch.train --device cpu`` with each data option that the
port runs: one toy epoch (slice 4096, fmaps 8/16) through ``train.main`` in this process
on a corpus of 10 slices (batches of 4: two whole and one ragged), with
``--random_scale``, ``--preemph_norm``, ``--shuffle_buffer``, ``--loader_dtype``, ``--h5``
(train.h5 and valid.h5 written by the port's ``tools/make_h5.py``) and ``--noises_dir``
under WSEGAN. The batches and files themselves are held against the JAX package in
``tests/test_torch_data_options.py`` and ``tests/test_torch_augment.py``."""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from segan_pytorch_tpu_torch import train as ttrain
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
from segan_pytorch_tpu_torch.tools import make_h5
from test_torch_augment import write_noises
from test_torch_data import write_pairs

TOY_ARGS = ["--batch_size", "4", "--slice_size", "4096", "--genc_fmaps", "8", "16",
            "--genc_poolings", "4", "4", "--z_dim", "16", "--denc_fmaps", "8", "16",
            "--denc_poolings", "4", "4", "--dpool_slen", "256", "--no_bias",
            "--no_train_gen", "--save_freq", "1", "--epoch", "1", "--device", "cpu"]
BATCH_RE = re.compile(r"\(Iter (\d+)\) Batch (\d+)/(\d+) \(Epoch 1\) d_real:(\S+), "
                      r"d_fake:(\S+), g_adv:(\S+), g_l1:(\S+) l1_w")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return root, write_pairs(root / "train", [12000, 10000, 9000])


def _run(tmp_path, corpus, extra, record=None, cls=SEGAN):
    """train.main with `extra`; `record` collects each train_step's arguments. Returns
    (engine, printed lines)."""
    root, dirs = corpus
    argv = ["--save_path", str(tmp_path / "ck"), "--clean_trainset", dirs[0],
            "--noisy_trainset", dirs[1], "--cache_dir", str(tmp_path / "cache")]
    step = cls.train_step

    def recorded(self, *a, **k):
        record.append(a)
        return step(self, *a, **k)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        if record is not None:
            mp.setattr(cls, "train_step", recorded)
        with contextlib.redirect_stdout(out):
            seg = ttrain.main(argv + TOY_ARGS + extra)
    return seg, out.getvalue()


def _losses(text):
    logged = BATCH_RE.findall(text)
    assert logged, text[-2000:]
    losses = np.array([[float(v) for v in m[3:]] for m in logged])
    assert np.isfinite(losses).all(), losses
    return logged


@pytest.mark.parametrize("extra", [["--random_scale", "0.5", "1", "2"], ["--preemph_norm"],
                                   ["--random_scale", "0.5", "2", "--preemph_norm"]],
                         ids=["random_scale", "preemph_norm", "both"])
def test_dataset_options_run_an_epoch(tmp_path, corpus, extra):
    seg, text = _run(tmp_path, corpus, extra)
    assert seg.step == 3 and [m[1] for m in _losses(text)] == ["1", "2", "3"]
    assert "[data] train: batches gathered in Python" in text


def test_shuffle_buffer_runs_the_buffered_epoch(tmp_path, corpus):
    """10 slices through a buffer of 4 in batches of 4: two batches, the tail dropped."""
    seg, text = _run(tmp_path, corpus, ["--shuffle_buffer", "4", "--shuffle_buffer_mode",
                                        "global"])
    assert seg.step == 2
    assert [(m[1], m[2]) for m in _losses(text)] == [("1", "2"), ("2", "2")]


def test_loader_dtype_feeds_the_step_bf16(tmp_path, corpus):
    """The step gets bf16 clean and noisy (the cast crossed as it is) and an fp32 mask."""
    calls = []
    seg, text = _run(tmp_path, corpus, ["--loader_dtype", "bfloat16"], calls)
    assert seg.step == 3 and len(_losses(text)) == 3
    assert [(c[0].dtype, c[1].dtype, c[2].dtype) for c in calls] == [
        (torch.bfloat16, torch.bfloat16, torch.float32)] * 3


def test_h5_runs_an_epoch_with_validation(tmp_path, corpus, monkeypatch):
    monkeypatch.setenv("SEGAN_TPU_PESQ", "approx")
    root, dirs = corpus
    h5 = tmp_path / "h5"
    for split in ("train", "valid"):
        make_h5.main(["--clean_dir", dirs[0], "--noisy_dir", dirs[1], "--out_dir", str(h5),
                      "--split", split, "--slice_size", "4096"])
    with pytest.raises(ValueError, match="H5 data root"):
        _run(tmp_path, corpus, ["--h5"])
    seg, text = _run(tmp_path, corpus, ["--h5", "--h5_data_root", str(h5), "--clean_valset",
                                        "unused", "--noisy_valset", "unused",
                                        "--eval_workers", "1"])
    assert seg.step == 3 and len(_losses(text)) == 3
    assert f"Found H5 file {h5 / 'train.h5'} with 10 samples" in text
    assert f"Found H5 file {h5 / 'valid.h5'} with 10 samples" in text
    assert "Time to process eval with 10 samples" in text


def test_noises_dir_switches_on_wsegan_s_additive_term(tmp_path, corpus):
    """--wsegan with --noises_dir: every row of every step is additive, and the additive
    L1 term (den_loss) is logged nonzero."""
    calls = []
    noises = write_noises(tmp_path / "noises")
    seg, text = _run(tmp_path, corpus, [
        "--wsegan", "--gnorm_type", "snorm", "--dnorm_type", "snorm", "--opt", "adam",
        "--misalign_pair", "--noises_dir", noises, "--snr_levels", "0", "5", "10"],
        calls, cls=WSEGAN)
    assert f"[augment] additive noise from {noises} at SNR [0, 5, 10] dB (3 noise files)" \
        in text
    assert seg.step == 3 and len(calls) == 3
    assert all(torch.equal(c[3], torch.ones(4)) for c in calls)
    dens = [float(v) for v in re.findall(r"den_loss: (\S+) btime", text)]
    assert dens and all(d > 0 for d in dens), text[-2000:]
