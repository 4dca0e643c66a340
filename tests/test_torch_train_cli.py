"""``python -m segan_pytorch_tpu_torch.train`` end to end on the CPU, in subprocesses, as
``tests/test_cli.py`` drives the repo's ``train.py``: one epoch, a resume to epoch 3,
the port's ``clean`` on the last checkpoint, then ``purge_ckpts.py`` on the save
directory."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from test_torch_data import write_pairs
from test_torch_loop import LOG_LINE, TOY_ARGS

ROOT = Path(__file__).resolve().parents[1]


def run_cli(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m"] + args, cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_trains_resumes_cleans_and_purges(tmp_path):
    corpus = (write_pairs(tmp_path / "train", [12000, 10000, 9000]),)
    save, cache = str(tmp_path / "ck"), str(tmp_path / "cache")
    base = ["segan_pytorch_tpu_torch.train", "--save_path", save, "--clean_trainset",
            corpus[0][0], "--noisy_trainset", corpus[0][1], "--cache_dir", cache,
            "--save_freq", "2", "--device", "cpu"] + TOY_ARGS
    r = run_cli(base + ["--epoch", "1"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "(Iter 3) Batch 3/3 (Epoch 1)" in r.stdout
    assert "[data] train: batches gathered by native/segan_io.cpp" in r.stdout
    opts = json.loads((tmp_path / "ck" / "train.opts").read_text())
    assert opts["genc_fmaps"] == [8, 16] and opts["bias"] is False and "device" not in opts
    assert (tmp_path / "ck" / "sample_2-0.wav").exists()
    first = json.loads((tmp_path / "ck" / "EOE_G-checkpoints").read_text())["current"]
    assert first == "EOE_G-Generator-4.ckpt"

    r = run_cli(base + ["--epoch", "3", "--resume"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[*] Resumed from step 3" in r.stdout
    assert LOG_LINE.findall(r.stdout)[0].startswith("(Iter 5) Batch 2/3 (Epoch 2)")
    idx = json.loads((tmp_path / "ck" / "EOE_G-checkpoints").read_text())
    assert idx["latest"] == ["EOE_G-Generator-4.ckpt", "EOE_G-Generator-7.ckpt",
                             "EOE_G-Generator-10.ckpt"]

    synth = tmp_path / "synth"
    r = run_cli(["segan_pytorch_tpu_torch.clean", "--g_pretrained_ckpt",
                 os.path.join(save, "weights_" + idx["current"]), "--cfg_file",
                 os.path.join(save, "train.opts"), "--test_files", corpus[0][1],
                 "--synthesis_path", str(synth), "--soundfile", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    from scipy.io import wavfile

    assert sorted(os.listdir(synth)) == ["utt0.wav", "utt1.wav", "utt2.wav"]
    rate, wav = wavfile.read(str(synth / "utt1.wav"))
    assert rate == 16000 and wav.shape == (10000,) and wav.dtype == np.int16

    r = subprocess.run([sys.executable, "purge_ckpts.py", save], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    for prefix in ("EOE_G-", "EOE_D-"):
        idx2 = json.loads((tmp_path / "ck" / f"{prefix}checkpoints").read_text())
        assert len(idx2["latest"]) == 1
    assert sorted(p.name for p in (tmp_path / "ck").glob("weights_*")) == [
        "weights_EOE_D-Discriminator-10.ckpt", "weights_EOE_G-Generator-10.ckpt"]
