"""``segan_pytorch_tpu_torch/tools/ab_parity.py`` against the repo's ``tools/ab_parity.py``
at toy width (slice 1024, fmaps 8/16/32, z_dim 32) on three synthetic test utterances.

Both tools load the same reference-format ``.ckpt`` and train.opts. Root enhances with
the JAX engine's own z draw and the port with a torch generator's, so each side's
``generate`` is wrapped to take one given z per utterance, the same on both sides. Then
the ``noisy`` rows are equal to 1e-9 (the same metrics on the same input), the enhanced
waveforms agree within 1e-5 (relative to the largest sample) and so their ``enh`` rows
within ENH_TOL, and the reports have the same layout. A control run of the port with
other z's moves the ``enh`` rows by more than that. Root runs in this process
(``runpy``, ``sys.argv`` patched).
"""
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.tools import ab_parity, make_demo_corpus
from segan_pytorch_tpu_torch.utils.checkpoint import save_generator
from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts

ROOT = Path(__file__).resolve().parents[1]
# D too: the JAX engine builds it (init_state) though the tool never runs it
TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], z_dim=32,
           no_bias=True, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16)
N_FILES = 3
WAV_TOL = 1e-5
# each metric of two waveforms within WAV_TOL of each other (on this CPU: the waveforms
# 2.5e-7 apart, the metrics 9.1e-8; the control's other z moved CSIG by 0.12)
ENH_TOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("ab")
    make_demo_corpus.main(["--out", str(work), "--n_train", "0", "--n_test",
                           str(N_FILES), "--dur", "1.2", "--style", "v2"])
    cfg = SEGANConfig(**TOY)
    g = torch.Generator().manual_seed(5)
    G = build_generator(cfg, g)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("act.weight"):
                p.uniform_(0.0, 0.3, generator=g)
    save_generator(G, str(work / "g.ckpt"))
    opts = dump_train_opts(cfg, str(work / "opts"))
    argv = ["--g_ckpt", str(work / "g.ckpt"), "--cfg_file", opts, "--clean_test",
            str(work / "clean_testset"), "--noisy_test", str(work / "noisy_testset")]
    return work, argv


def _given_z(monkeypatch, cls, zs, outs):
    """Make cls.generate take zs[i] on its i-th call and keep its output in `outs`."""
    orig, calls = cls.generate, iter(zs)

    def generate(self, inwav, z=None, **kw):
        enh, extra = orig(self, inwav, z=next(calls), **kw)
        outs.append(np.asarray(enh, np.float64))
        return enh, extra

    monkeypatch.setattr(cls, "generate", generate)


def _zs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 16, 32).astype(np.float32) for _ in range(N_FILES)]


def test_report_equals_the_root_tool_with_one_z(setup, tmp_path, monkeypatch):
    work, argv = setup
    zs, root_enh, port_enh = _zs(1), [], []
    _given_z(monkeypatch, JaxSEGAN, zs, root_enh)
    monkeypatch.setattr(sys, "argv", ["ab_parity.py", *argv, "--out",
                                      str(tmp_path / "root.json")])
    runpy.run_path(str(ROOT / "tools/ab_parity.py"), run_name="__main__")
    _given_z(monkeypatch, SEGAN, zs, port_enh)
    got = ab_parity.main([*argv, "--out", str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "root.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got

    assert len(root_enh) == len(port_enh) == N_FILES
    for a, b in zip(port_enh, root_enh):
        assert a.shape == b.shape and np.abs(a - b).max() / np.abs(b).max() <= WAV_TOL
    assert list(got) == list(want) == ["n_files", "means", "paper_rows", "rows"]
    assert got["n_files"] == want["n_files"] == N_FILES
    assert got["paper_rows"] == want["paper_rows"]
    assert list(got["means"]) == list(want["means"]) == ["noisy", "enh"]
    for g, w in zip(got["rows"], want["rows"]):
        assert list(g) == list(w) == ["file", "noisy", "enh"] and g["file"] == w["file"]
        assert list(g["noisy"]) == list(w["noisy"]) == ["pesq", "stoi", "csig", "cbak",
                                                        "covl", "ssnr"]
        for k in w["noisy"]:
            assert abs(g["noisy"][k] - w["noisy"][k]) <= 1e-9, (g["file"], k)
            assert abs(g["enh"][k] - w["enh"][k]) <= ENH_TOL, (g["file"], k)

    # control: other z's on the port's side move the enhanced rows beyond ENH_TOL
    monkeypatch.undo()
    ctrl = []
    _given_z(monkeypatch, SEGAN, _zs(2), ctrl)
    other = ab_parity.main([*argv, "--out", str(tmp_path / "ctrl.json"), "--device", "cpu"])
    moved = max(abs(g["enh"][k] - w["enh"][k]) for g, w in zip(other["rows"], want["rows"])
                for k in w["enh"])
    assert moved > 100 * ENH_TOL


def test_z_is_the_engines_own_draw(setup, tmp_path):
    """Without a given z the port draws each utterance's z from the engine's stream, as
    ``generate`` itself would: two runs with one --seed agree, another --seed differs."""
    _, argv = setup
    runs = [ab_parity.main([*argv, "--out", str(tmp_path / f"{i}.json"), "--device", "cpu",
                            "--seed", str(seed), "--max_files", "1"])
            for i, seed in enumerate((3, 3, 4))]
    assert runs[0]["n_files"] == 1 and runs[0]["rows"] == runs[1]["rows"]
    assert runs[0]["rows"][0]["enh"] != runs[2]["rows"][0]["enh"]
    assert runs[0]["rows"][0]["noisy"] == runs[2]["rows"][0]["noisy"]
