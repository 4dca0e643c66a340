"""``python -m segan_pytorch_tpu_torch.train`` with scripts/run_wsegan_train.sh's flags and
with ``--aewsegan``, at toy width on the CPU in subprocesses: train, resume, the port's
clean CLI on the last EOE G, the validation score of AEWSEGAN, and SIGTERM."""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from test_torch_data import write_pairs

ROOT = Path(__file__).resolve().parents[1]
# the shipped script's flags, every other option at its default (G and D with biases)
WSEGAN_FLAGS = ["--no_train_gen", "--wsegan", "--gnorm_type", "snorm", "--dnorm_type",
                "snorm", "--opt", "adam", "--data_stride", "0.05", "--misalign_pair"]
TOY_ARGS = ["--batch_size", "4", "--slice_size", "4096", "--genc_fmaps", "8", "16",
            "--genc_poolings", "4", "4", "--z_dim", "16", "--denc_fmaps", "8", "16",
            "--denc_poolings", "4", "4", "--dpool_slen", "256", "--save_freq", "2",
            "--device", "cpu"]


def run_cli(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m"] + args, cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=timeout)


def _base(tmp_path, corpus, save="ck"):
    return ["segan_pytorch_tpu_torch.train", "--save_path", str(tmp_path / save),
            "--clean_trainset", corpus[0], "--noisy_trainset", corpus[1], "--cache_dir",
            str(tmp_path / "cache")] + TOY_ARGS


def test_wsegan_cli_trains_resumes_and_cleans(tmp_path):
    """Slices at stride 0.05 of two utterances: 15, four batches an epoch. One epoch,
    then --resume to epoch 2, which runs only iterations 5-8; then clean on the last EOE
    G, which enhances each wav in one padded pass (its output keeps the input length)."""
    corpus = write_pairs(tmp_path / "train", [6000, 5000])
    base = _base(tmp_path, corpus) + WSEGAN_FLAGS
    r = run_cli(base + ["--epoch", "1"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Iter 2/4 (4 bpe) d_loss:" in r.stdout and "Iter 4/4 (4 bpe)" in r.stdout
    opts = json.loads((tmp_path / "ck" / "train.opts").read_text())
    assert opts["wsegan"] and opts["gnorm_type"] == "snorm" and opts["bias"] is True
    idx = json.loads((tmp_path / "ck" / "EOE_G-checkpoints").read_text())
    assert idx["current"] == "EOE_G-Generator-4.ckpt"
    r = run_cli(base + ["--epoch", "2", "--resume"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[*] Resumed from step 4" in r.stdout
    assert "Iter 6/8 (4 bpe)" in r.stdout and "Iter 2/" not in r.stdout
    idx = json.loads((tmp_path / "ck" / "EOE_D-checkpoints").read_text())
    assert idx["latest"] == ["EOE_D-Discriminator-4.ckpt", "EOE_D-Discriminator-8.ckpt"]

    synth = tmp_path / "synth"
    r = run_cli(["segan_pytorch_tpu_torch.clean", "--g_pretrained_ckpt",
                 str(tmp_path / "ck" / "weights_EOE_G-Generator-8.ckpt"), "--cfg_file",
                 str(tmp_path / "ck" / "train.opts"), "--test_files", corpus[1],
                 "--synthesis_path", str(synth), "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    from scipy.io import wavfile

    for name, n in (("utt0.wav", 6000), ("utt1.wav", 5000)):
        rate, wav = wavfile.read(str(synth / name))
        assert rate == 16000 and wav.shape == (n,)


def test_aewsegan_cli_scores_the_validation_set(tmp_path):
    """--aewsegan: G alone (no D checkpoint), the spectral distortion of the validation
    set logged as Genh_SD at each log point, the best G kept, and the TPU lowering
    default recorded in train.opts."""
    corpus = write_pairs(tmp_path / "train", [6000, 5000])
    valid = write_pairs(tmp_path / "valid", [8192], seed=1)
    r = run_cli(_base(tmp_path, corpus) + [
        "--aewsegan", "--opt", "adam", "--epoch", "1", "--data_stride", "0.05",
        "--clean_valset", valid[0], "--noisy_valset", valid[1], "--no_train_gen"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Iter 4/4 (4 bpe) g_l2_loss:" in r.stdout
    save = tmp_path / "ck"
    scalars = [json.loads(line) for line in
               (save / "train" / "scalars.jsonl").read_text().splitlines()]
    sds = [s["value"] for s in scalars if s["tag"] == "Genh_SD"]
    assert len(sds) == 2 and all(v > 0 for v in sds)
    assert json.loads((save / "train.opts").read_text())["deconv_impl"] == "edge-blocked"
    assert (save / "AEWSEGAN-G-checkpoints").exists()
    assert (save / "weights_EOE_G-Generator-4.ckpt").exists()
    assert not list(save.glob("*Discriminator*"))


def test_wsegan_sigterm_checkpoints_and_exits_cleanly(tmp_path):
    corpus = write_pairs(tmp_path / "train", [6000, 5000])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.Popen(
        [sys.executable, "-u", "-m"] + _base(tmp_path, corpus) + WSEGAN_FLAGS
        + ["--epoch", "200"], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 120
    lines = []
    for line in p.stdout:
        lines.append(line)
        if line.startswith("Iter ") or time.time() > deadline:
            break
    p.send_signal(signal.SIGTERM)
    out = "".join(lines) + p.stdout.read()
    rc = p.wait(timeout=60)
    assert rc == 0, out[-2000:]
    assert "SIGTERM" in out and "preempted at iteration" in out, out[-2000:]
    save = tmp_path / "ck"
    g = json.loads((save / "EOE_G-checkpoints").read_text())["current"]
    d = json.loads((save / "EOE_D-checkpoints").read_text())["current"]
    assert g.split("-")[-1] == d.split("-")[-1]
    assert (save / f"weights_{g}").exists() and (save / f"weights_{d}").exists()
