"""``python -m segan_pytorch_tpu_torch.train`` on several processes, on the CPU, at toy
width (slice 4096, fmaps 8/16 in G and D, global batch 4): ``--dp 2`` alone spawns two
processes on this host, ``--dp 2 --mp 2`` four, and the multi-host flags
(``--coordinator``, ``--num_processes``, ``--process_id``) join two processes launched
apart, here to resume the ``--dp 2`` run. Each run must end with exit code 0, only the
chief's files written, and checkpoints that load into one process. These four flags were
refused by the port before it ran them (``tests/test_torch_loop.py`` held the refusals,
case for case, as these cases hold the runs)."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.utils.checkpoint import Saver
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import write_pairs

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(slice_size=4096, genc_fmaps=[8, 16], genc_poolings=[4, 4], z_dim=16,
           denc_fmaps=[8, 16], denc_poolings=[4, 4], dpool_slen=256, no_bias=True,
           batch_size=4)
TOY_ARGS = ["--batch_size", "4", "--slice_size", "4096", "--genc_fmaps", "8", "16",
            "--genc_poolings", "4", "4", "--z_dim", "16", "--denc_fmaps", "8", "16",
            "--denc_poolings", "4", "4", "--dpool_slen", "256", "--no_bias",
            "--device", "cpu", "--save_freq", "1", "--eval_workers", "1"]
# the processes share the log: a line of one may end inside a line of another
ITER = re.compile(r"\(Iter (\d+)\) Batch (\d+)/(\d+) \(Epoch (\d+)\) (d_real:\S+ d_fake:\S+ "
                  r"g_adv:\S+ g_l1:\S+)")
DEADLINE_S = 150


def _start(args, log: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "segan_pytorch_tpu_torch.train"] + args,
                            cwd=str(ROOT), env=env, stdout=open(log, "w"),
                            stderr=subprocess.STDOUT)


def _finish(procs):
    """Exit codes of the runs, each killed at the deadline rather than left hanging."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=DEADLINE_S))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three runs started together: 'dp', one epoch at --dp 2 with a validation set;
    'mp', one epoch at --dp 2 --mp 2; 'hosts', two processes with the multi-host flags
    that resume a one-process run directory (saved here after 3 steps) to epoch 2. Each:
    (exit codes, logs, save path)."""
    root = tmp_path_factory.mktemp("dpcli")
    train = write_pairs(root / "train", [12000, 10000, 9000])  # 10 slices: 3 batches
    valid = write_pairs(root / "valid", [8192], seed=1)
    data = ["--clean_trainset", train[0], "--noisy_trainset", train[1],
            "--cache_dir", str(root / "cache")]
    # the slice caches first, so that the two runs started together do not write them
    # at once
    from segan_pytorch_tpu_torch.data.se_dataset import SEDataset

    SEDataset(*train, 0.95, cache_dir=str(root / "cache"), slice_size=4096)
    SEDataset(*valid, 0.95, cache_dir=str(root / "cache"), split="valid", slice_size=4096)
    one = SEGAN(SEGANConfig(**TOY), device="cpu")
    one.init_train()
    one.step = 3
    one.save(Saver(str(root / "hosts"), prefix="EOE_G-"),
             Saver(str(root / "hosts"), prefix="EOE_D-"), 4)
    starts = {
        "dp": data + ["--save_path", str(root / "dp"), "--epoch", "1", "--dp", "2",
                      "--clean_valset", valid[0], "--noisy_valset", valid[1]],
        "mp": data + ["--save_path", str(root / "mp"), "--epoch", "1", "--dp", "2",
                      "--mp", "2"],
    }
    procs = {k: [_start(a + TOY_ARGS, root / f"{k}.log")] for k, a in starts.items()}
    hosts = data + ["--save_path", str(root / "hosts"), "--epoch", "2", "--resume",
                    "--coordinator", f"file://{root}/rendezvous", "--num_processes", "2"]
    procs["hosts"] = [_start(hosts + ["--process_id", str(i)] + TOY_ARGS,
                             root / f"hosts{i}.log") for i in range(2)]
    codes = _finish([p for ps in procs.values() for p in ps])
    logs = {k: [(root / f"{k}.log").read_text()] for k in starts}
    logs["hosts"] = [(root / f"hosts{i}.log").read_text() for i in range(2)]
    return {"dp": (codes[:1], logs["dp"], root / "dp"),
            "mp": (codes[1:2], logs["mp"], root / "mp"),
            "hosts": (codes[2:], logs["hosts"], root / "hosts")}


def _iterations(log: str):
    return [(int(m[0]), m[4]) for m in ITER.findall(log)]


def _index(save: Path, prefix: str) -> dict:
    return json.loads((save / f"{prefix}checkpoints").read_text())


def _check_dp(codes, logs, save):
    """Both processes log iterations 1-3 with the same global losses; the chief alone
    wrote the scalars (one D_real per log point), the samples (its 2 rows) and the
    checkpoints; the payloads load into one process's D."""
    assert codes == [0], logs[0][-3000:]
    its = _iterations(logs[0])
    assert sorted(i for i, _ in its) == [1, 1, 2, 2, 3, 3], its
    for i in (1, 2, 3):
        assert len({losses for j, losses in its if j == i}) == 1, its
    assert "Time to process eval with" in logs[0]
    tags = [(e["tag"], e["step"]) for e in map(json.loads, (save / "train" /
                                                           "scalars.jsonl").read_text()
                                                .splitlines())]
    assert [s for t, s in tags if t == "D_real"] == [1, 2, 3], tags
    assert [s for t, s in tags if t == "Genh-pesq"] == [1], tags
    assert sorted(p.name for p in save.glob("sample_3-*.wav")) == ["sample_3-0.wav",
                                                                 "sample_3-1.wav"]
    assert _index(save, "EOE_G-")["current"] == "EOE_G-Generator-4.ckpt"


def _check_mp(codes, logs, save):
    """--dp 2 --mp 2: four processes, one step of the global batch each iteration; the
    EOE checkpoint holds D's whole head and strict-loads into one process's D."""
    assert codes == [0], logs[0][-3000:]
    its = _iterations(logs[0])
    assert sorted({i for i, _ in its}) == [1, 2, 3] and len(its) == 12, its
    payload, _ = Saver(str(save), prefix="EOE_D-").load_weights()
    D = build_discriminator(SEGANConfig(**TOY))
    D.load_state_dict(payload["state_dict"], strict=True)
    assert payload["state_dict"]["fc.0.weight"].shape == (256, 256 * 16)
    assert payload["optimizer"]["state"][
        list(dict(D.named_parameters())).index("fc.0.weight")]["square_avg"].shape == (
        256, 256 * 16)


def _check_hosts(codes, logs, save):
    """Two processes launched apart join through --coordinator: both resume from step 3,
    run iterations 4-6 of epoch 2 with the same losses and the chief writes the epoch's
    checkpoint."""
    assert codes == [0, 0], [log[-3000:] for log in logs]
    for log in logs:
        assert "[*] Resumed from step 3" in log, log[-3000:]
        assert "defaulting --dp to 2" in log
        assert sorted(i for i, _ in _iterations(log)) == [4, 5, 6]
    assert _iterations(logs[0]) == _iterations(logs[1])
    assert _index(save, "EOE_G-")["current"] == "EOE_G-Generator-7.ckpt"


CASES = {"--dp": ("dp", _check_dp), "--mp": ("mp", _check_mp),
         "--coordinator": ("hosts", _check_hosts), "--num_processes": ("hosts", _check_hosts)}


@pytest.mark.parametrize("flag", list(CASES))
def test_multiprocess_flags_train(runs, flag):
    run, check = CASES[flag]
    check(*runs[run])


def test_more_processes_than_cards_is_refused(monkeypatch):
    """On the card one process drives one card: two processes on a machine of one card
    are refused before any starts, and without a card CUDA is refused."""
    from segan_pytorch_tpu_torch.parallel.mesh import spawn_local

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 processes need 2 devices, have 1"):
        spawn_local(print, 2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        spawn_local(print, 2, "cuda")
