"""The port's training run (``SEGAN.train``, ``evaluate``, ``save``, ``resume`` and
``python -m segan_pytorch_tpu_torch.train``) against the JAX package's at toy width
(slice 4096, fmaps 8/16 in G and D) on a synthetic corpus, on the CPU.

With the train step stubbed in both packages (it records what it is given and returns
fixed losses) the two loops must feed the same batches and L1 weights, log the same
iterations, write the same checkpoint names and indices, and stop early at the same
epoch. Then: evaluate() scores like the JAX one, checkpoints cross between the packages,
resume restores the run bit for bit, and the CLI checkpoints on SIGTERM, refuses to
run on the CPU unasked and raises on every option it does not run yet
(``tests/test_torch_train_cli.py`` drives it through training, resume, ``clean`` and
``purge_ckpts.py``)."""
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segan_pytorch_tpu.data import DataLoader as JaxLoader, SEDataset as JaxDataset
from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.utils.checkpoint import Saver as JaxSaver
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch import train as ttrain
from segan_pytorch_tpu_torch.data.loader import DataLoader
from segan_pytorch_tpu_torch.data.se_dataset import SEDataset
from segan_pytorch_tpu_torch.models.segan import SEGAN, unported_options
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from segan_pytorch_tpu_torch.utils.checkpoint import Saver, save_generator
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import write_pairs

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(slice_size=4096, genc_fmaps=[8, 16], genc_poolings=[4, 4], z_dim=16,
           denc_fmaps=[8, 16], denc_poolings=[4, 4], dpool_slen=256, no_bias=True,
           batch_size=4)
TOY_ARGS = ["--batch_size", "4", "--slice_size", "4096", "--genc_fmaps", "8", "16",
            "--genc_poolings", "4", "4", "--z_dim", "16", "--denc_fmaps", "8", "16",
            "--denc_poolings", "4", "4", "--dpool_slen", "256", "--no_bias"]
METRICS = {"d_real": 0.25, "d_fake": 0.5, "g_adv": 0.75, "g_l1": 1.0}
LOG_LINE = re.compile(r"^\(Iter \d+\) Batch \d+/\d+ \(Epoch \d+\).* l1_w: [\d.]+", re.M)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """10 training slices (batches of 4: the third one ragged, 2 rows) and 5 validation
    slices of 2 utterances."""
    root = tmp_path_factory.mktemp("loop")
    train = write_pairs(root / "train", [12000, 10000, 9000])
    valid = write_pairs(root / "valid", [8192, 8000], seed=1)
    return train, valid, root


def _loader(pkg, dirs, cache, batch=4, shuffle=True):
    ds_cls, dl_cls = (JaxDataset, JaxLoader) if pkg == "jax" else (SEDataset, DataLoader)
    ds = ds_cls(*dirs, 0.95, cache_dir=str(cache), slice_size=4096, slice_workers=1)
    return dl_cls(ds, batch_size=batch, shuffle=shuffle, num_workers=1, seed=5)


# the val_obj (COVL + PESQ + SSNR) of each epoch: better, better, worse, worse -> with a
# patience of 2 the run stops after the fourth epoch
VAL_OBJS = [3.0, 5.0, 4.0, 4.5, 6.0]
SCENARIOS = {
    "three_epochs": dict(epoch=3, patience=100, val=False),
    "early_stop": dict(epoch=10, patience=2, val=True),
}


def _stubbed_run(pkg, scenario, corpus, root):
    """One training run of `pkg` with the step (and evaluate) stubbed. Returns what the
    step got, the log lines and the save directory."""
    sc = SCENARIOS[scenario]
    save = root / f"{pkg}-{scenario}"
    kw = dict(TOY, save_path=str(save), epoch=sc["epoch"], patience=sc["patience"],
              no_train_gen=True)
    calls, evals = [], []

    def scored(cfg, dloader, log_freq, do_noisy=False, max_samples=1):
        v = VAL_OBJS[len(evals)]
        evals.append(v)
        out = {"covl": [v / 2, v / 2], "pesq": [v / 4] * 2, "ssnr": [v / 4] * 2,
               "csig": [1.0] * 2, "cbak": [1.0] * 2}
        return (out, dict(out)) if do_noisy else out

    if pkg == "jax":
        seg = JaxSEGAN(JaxConfig(**kw))
        seg.init_state(jax.random.PRNGKey(0), batch_size=4)

        def step(clean, noisy, mask, rng, l1_weight):
            calls.append((np.asarray(clean), np.asarray(noisy), np.asarray(mask),
                          l1_weight))
            return dict(METRICS), np.zeros(np.shape(clean), np.float32), None
    else:
        seg = SEGAN(SEGANConfig(**kw), device="cpu")

        def step(clean, noisy, mask=None, l1_weight=100.0):
            calls.append((clean.numpy(), noisy.numpy(), mask.numpy(), l1_weight))
            seg.step += 1
            return ({k: torch.tensor(v) for k, v in METRICS.items()},
                    torch.zeros_like(clean), None)
    seg.train_step = step
    seg.evaluate = scored
    dl = _loader(pkg, corpus[0], root / f"cache-{pkg}")
    va = _loader(pkg, corpus[1], root / f"vcache-{pkg}", batch=300) if sc["val"] else None
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if pkg == "jax":
            seg.train(seg.cfg, dl, None, l1_init=100.0, l1_dec_step=0.5, l1_dec_epoch=2,
                      log_freq=2, va_dloader=va)
        else:
            seg.train(seg.cfg, dl, l1_init=100.0, l1_dec_step=0.5, l1_dec_epoch=2,
                      log_freq=2, va_dloader=va)
    return calls, LOG_LINE.findall(out.getvalue()), save, evals, out.getvalue()


@pytest.fixture(scope="module", params=list(SCENARIOS))
def stubbed(request, corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    return {pkg: _stubbed_run(pkg, request.param, corpus, root) for pkg in ("jax", "port")}


def test_loop_feeds_the_same_batches_and_l1_weights(stubbed):
    jcalls, tcalls = stubbed["jax"][0], stubbed["port"][0]
    assert len(tcalls) == len(jcalls) and len(tcalls) % 3 == 0
    for (jc, jn, jm, jl), (tc, tn, tm, tl) in zip(jcalls, tcalls):
        assert tc.shape == (4, 4096, 1)
        assert np.array_equal(jc, tc) and np.array_equal(jn, tn)
        assert np.array_equal(jm, tm) and jl == tl
    assert [c[2].tolist() for c in tcalls[:3]] == [[1] * 4, [1] * 4, [1, 1, 0, 0]]
    # epoch 1 keeps the initial weight, then it decays by 0.5 per batch
    assert [c[3] for c in tcalls[:6]] == [100.0] * 3 + [99.5, 99.0, 98.5]


def test_loop_logs_the_same_iterations(stubbed):
    jlog, tlog = stubbed["jax"][1], stubbed["port"][1]
    assert tlog == jlog and tlog[:2] == [
        "(Iter 2) Batch 2/3 (Epoch 1) d_real:0.2500, d_fake:0.5000, g_adv:0.7500, "
        "g_l1:1.0000 l1_w: 100.00",
        "(Iter 3) Batch 3/3 (Epoch 1) d_real:0.2500, d_fake:0.5000, g_adv:0.7500, "
        "g_l1:1.0000 l1_w: 100.00"]


def test_loop_writes_the_same_checkpoint_names_and_indices(stubbed):
    jdir, tdir = stubbed["jax"][2], stubbed["port"][2]
    names = sorted(p.name for p in tdir.iterdir() if p.name.startswith("weights_"))
    assert names == sorted(p.name for p in jdir.iterdir() if p.name.startswith("weights_"))
    indices = sorted(p.name for p in tdir.iterdir() if p.name.endswith("checkpoints"))
    assert indices == sorted(p.name for p in jdir.iterdir()
                             if p.name.endswith("checkpoints"))
    for name in indices:
        assert json.loads((tdir / name).read_text()) == json.loads((jdir / name).read_text())
    assert "EOE_G-checkpoints" in indices


def test_early_stop_at_the_same_epoch(stubbed):
    (jcalls, _, jdir, jevals, jout), (tcalls, _, tdir, tevals, tout) = (stubbed["jax"],
                                                                       stubbed["port"])
    assert tevals == jevals
    if not jevals:  # the scenario without a validation set
        return
    assert len(tevals) == 4 and len(tcalls) == 12
    assert "STOPPING SEGAN TRAIN: OUT OF PATIENCE." in tout and jout.count(
        "OUT OF PATIENCE") == tout.count("OUT OF PATIENCE") == 1
    best = json.loads((tdir / "SEGAN-G-checkpoints").read_text())
    assert best["latest"] == ["SEGAN-G-best_Generator-4.ckpt",
                              "SEGAN-G-best_Generator-7.ckpt"]


def _toy_engine(tmp_path, pkg="port", **kw):
    cfg = dict(TOY, save_path=str(tmp_path), **kw)
    if pkg == "jax":
        seg = JaxSEGAN(JaxConfig(**cfg))
        seg.init_state(jax.random.PRNGKey(0), batch_size=4)
        return seg
    seg = SEGAN(SEGANConfig(**cfg), device="cpu")
    with torch.no_grad():  # slopes off 0, so that a broken negative branch shows
        for name, p in seg.G.named_parameters():
            if name.endswith("act.weight"):
                p.uniform_(0.0, 0.3, generator=torch.Generator().manual_seed(9))
    return seg


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """One real epoch of the port (3 steps), and its save directory."""
    save = tmp_path_factory.mktemp("trained")
    seg = _toy_engine(save, no_train_gen=True, epoch=1)
    seg.train(seg.cfg, _loader("port", corpus[0], save / "cache"), 100.0, 1e-5, 1, 100)
    return seg, save


def test_evaluate_scores_like_jax_and_the_pool_like_in_process(corpus, tmp_path,
                                                               monkeypatch):
    """no_z, the same G through the bridge, PESQ pinned to the spectral approximation in
    both: per-utterance metrics within 1e-3; the spawned pool equals in-process."""
    monkeypatch.setenv("SEGAN_TPU_PESQ", "approx")
    seg = _toy_engine(tmp_path / "t", no_z=True, eval_workers=2)
    save_generator(seg.G, str(tmp_path / "g.ckpt"))
    jseg = _toy_engine(tmp_path / "j", "jax", no_z=True, eval_workers=2)
    jseg.g_load_pretrained(str(tmp_path / "g.ckpt"), True)
    va = _loader("port", corpus[1], tmp_path / "vc", batch=300, shuffle=False)
    jva = _loader("jax", corpus[1], tmp_path / "jvc", batch=300, shuffle=False)
    got_e, got_n = seg.evaluate(seg.cfg, va, 100, do_noisy=True)
    want_e, want_n = jseg.evaluate(jseg.cfg, jva, 100, do_noisy=True)
    jseg.close_pool()
    assert seg.pool is not None
    seg.close_pool()
    for got, want in ((got_e, want_e), (got_n, want_n)):
        assert list(got) == ["pesq", "ssnr", "csig", "cbak", "covl"]
        for k in got:
            assert len(got[k]) == 5
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)

    class InProcess:
        def map(self, fn, args):
            return [fn(a) for a in args]

        def close(self):
            pass

        join = close

    seg.pool = InProcess()
    assert seg.evaluate(seg.cfg, va, 100) == got_e


def test_evaluate_z_is_fixed_per_step(tmp_path):
    seg = _toy_engine(tmp_path)
    z1, z2 = seg._eval_z((3, 4096, 1), 1), seg._eval_z((3, 4096, 1), 1)
    assert torch.equal(z1, z2) and z1.shape == (3, 256, 16)
    assert not torch.equal(z1, seg._eval_z((3, 4096, 1), 2))
    seg.step = 7
    assert not torch.equal(z1, seg._eval_z((3, 4096, 1), 1))


def test_the_port_eoe_payload_loads_in_jax(trained, tmp_path):
    seg, save = trained
    index = json.loads((save / "EOE_G-checkpoints").read_text())
    assert index["latest"] == ["EOE_G-Generator-4.ckpt"]
    payload = torch.load(save / ("weights_" + index["current"]), weights_only=True)
    assert set(payload) == {"step", "state_dict", "optimizer"} and payload["step"] == 3
    jseg = _toy_engine(tmp_path, "jax")
    jseg.g_load_pretrained(str(save / ("weights_" + index["current"])), True)
    jseg.d_load_pretrained(str(save / "weights_EOE_D-Discriminator-4.ckpt"), True)
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 4096, 1) * 0.3).astype(np.float32)
    z = rng.randn(3, 256, 16).astype(np.float32)
    want = np.asarray(jseg.infer_G(jnp.asarray(x), jnp.asarray(z)))
    got = seg.infer_G(x, z).numpy()
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= 1e-5


def test_a_jax_eoe_checkpoint_loads_strictly_through_the_cli(corpus, tmp_path):
    jseg = _toy_engine(tmp_path / "j", "jax")
    g_saver = JaxSaver(str(tmp_path / "j"), max_ckpts=3, prefix="EOE_G-")
    d_saver = JaxSaver(str(tmp_path / "j"), max_ckpts=3, prefix="EOE_D-")
    jseg.save(g_saver, d_saver, 5)
    g_npz = str(tmp_path / "j" / "weights_EOE_G-Generator-5.ckpt")
    d_npz = str(tmp_path / "j" / "weights_EOE_D-Discriminator-5.ckpt")
    seg = ttrain.main(["--save_path", str(tmp_path / "t"), "--clean_trainset",
                       corpus[0][0], "--noisy_trainset", corpus[0][1], "--cache_dir",
                       str(tmp_path / "c"), "--epoch", "0", "--g_pretrained_ckpt", g_npz,
                       "--d_pretrained_ckpt", d_npz, "--device", "cpu"] + TOY_ARGS)
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 4096, 1) * 0.3).astype(np.float32)
    z = rng.randn(2, 256, 16).astype(np.float32)
    want = np.asarray(jseg.infer_G(jnp.asarray(x), jnp.asarray(z)))
    got = seg.infer_G(x, z).numpy()
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= 1e-5
    jd = jax.tree.leaves(jseg.state.d_params["enc_blocks_0"]["conv"]["weight"])[0]
    torch.testing.assert_close(seg.D.enc_blocks[0].conv.weight,
                               torch.from_numpy(np.transpose(np.asarray(jd), (2, 1, 0))))


def test_resume_restores_the_run_bit_for_bit(trained, corpus, tmp_path):
    seg, save = trained
    fresh = _toy_engine(tmp_path, epoch=2)
    w = fresh.G.enc_blocks[1].conv.weight
    stale = K._padded_weights(w)[0].clone()
    assert fresh.resume(str(save)) == 3 == seg.step == fresh.step
    for a, b in ((seg.G, fresh.G), (seg.D, fresh.D)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for a, b in ((seg.g_opt, fresh.g_opt), (seg.d_opt, fresh.d_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys() and len(sa) > 0
        for i in sa:
            assert torch.equal(sa[i]["square_avg"], sb[i]["square_avg"])
            assert torch.equal(sa[i]["step"], sb[i]["step"])
    # the kernel's cached weights follow the loaded ones
    fresh_pad = K._padded_weights(w)[0]
    assert torch.equal(fresh_pad, K._mma_weights(w)[0]) and not torch.equal(fresh_pad, stale)
    # the L1 schedule and the iterations go on from step 3: with l1_dec_epoch = 1 the
    # JAX fast-forward gives l1_init - dec x 3, and the next batch decays once more
    l1s = []

    def step(clean, noisy, mask=None, l1_weight=100.0):
        l1s.append(l1_weight)
        fresh.step += 1
        return ({k: torch.tensor(v) for k, v in METRICS.items()}, torch.zeros_like(clean),
                None)

    fresh.train_step = step
    fresh.cfg.no_train_gen = True
    fresh.train(fresh.cfg, _loader("port", corpus[0], tmp_path / "c"), 100.0, 0.5, 1, 100)
    assert l1s == [100.0 - 0.5 * 4, 100.0 - 0.5 * 5, 100.0 - 0.5 * 6]
    index = json.loads((tmp_path / "EOE_G-checkpoints").read_text())
    assert index["current"] == "EOE_G-Generator-7.ckpt"


def test_saver_index_equals_the_jax_one(tmp_path):
    """Six saves with max_ckpts 3 and a best_val among them: the rotation deletes the
    same payloads and leaves the same index; the async saver writes the same."""
    seg = _toy_engine(tmp_path / "m")
    seg.init_train()
    tree = {"w": np.zeros(3, np.float32)}
    for d, async_write in (("sync", False), ("async", True)):
        js = JaxSaver(str(tmp_path / f"j{d}"), max_ckpts=3, prefix="EOE_G-")
        ts = Saver(str(tmp_path / f"t{d}"), max_ckpts=3, prefix="EOE_G-",
                   async_write=async_write)
        for step, best in ((3, False), (6, False), (9, True), (12, False), (15, False),
                           (18, True)):
            js.save("Generator", step, tree, best_val=best)
            ts.save("Generator", step, seg.G, seg.g_opt, best_val=best)
        ts.flush()
        assert ts.read_latest_checkpoint() == js.read_latest_checkpoint()
        for name in ("EOE_G-checkpoints",):
            assert (json.loads((tmp_path / f"t{d}" / name).read_text())
                    == json.loads((tmp_path / f"j{d}" / name).read_text()))
        assert sorted(os.listdir(tmp_path / f"t{d}")) == sorted(
            os.listdir(tmp_path / f"j{d}"))
        payload, meta = ts.load_weights()
        assert meta == {"step": 18} and set(payload["state_dict"]) == set(
            seg.G.state_dict())


def test_an_async_save_failure_surfaces_on_flush(tmp_path):
    seg = _toy_engine(tmp_path / "m")
    blocker = tmp_path / "file"
    blocker.write_text("")
    ts = Saver(str(blocker / "sub"), prefix="EOE_G-", async_write=True)
    ts.save("Generator", 1, seg.G)
    with pytest.raises(OSError):
        ts.flush()


def test_sigterm_checkpoints_and_exits_cleanly(corpus, tmp_path):
    save = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.Popen(
        [sys.executable, "-u", "-m", "segan_pytorch_tpu_torch.train", "--save_path",
         str(save), "--clean_trainset", corpus[0][0], "--noisy_trainset", corpus[0][1],
         "--cache_dir", str(tmp_path / "cache"), "--epoch", "200", "--save_freq", "1",
         "--no_train_gen", "--device", "cpu"] + TOY_ARGS,
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.time() + 120
    lines = []
    for line in p.stdout:
        lines.append(line)
        if "(Iter" in line or time.time() > deadline:
            break
    p.send_signal(signal.SIGTERM)
    out = "".join(lines) + p.stdout.read()
    rc = p.wait(timeout=60)
    assert rc == 0, out[-2000:]
    assert "SIGTERM" in out and "preempted at iteration" in out, out[-2000:]
    idx = json.loads((save / "EOE_G-checkpoints").read_text())
    assert (save / ("weights_" + idx["current"])).exists()
    assert (save / ("weights_" + idx["current"].replace("G-Generator", "D-Discriminator")
                    .replace("EOE_G", "EOE_D"))).exists()


def test_no_silent_cpu(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--save_path", str(tmp_path / "ck"), "--clean_trainset", corpus[0][0],
            "--noisy_trainset", corpus[0][1]] + TOY_ARGS
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(argv)
    assert not (tmp_path / "ck").exists()


UNPORTED = {
    "--wsegan": [], "--aewsegan": [], "--h5": [], "--noises_dir": ["noise"],
    "--shuffle_buffer": ["64"], "--steps_per_call": ["2"], "--profile": [],
    "--loader_dtype": ["bfloat16"], "--dp": ["2"], "--mp": ["2"],
    "--coordinator": ["localhost:1234"], "--num_processes": ["2"],
    "--random_scale": ["0.5", "1"], "--preemph_norm": [],
}


@pytest.mark.parametrize("flag", list(UNPORTED))
def test_unported_flags_raise(flag, tmp_path):
    argv = ["--save_path", str(tmp_path / "ck"), "--device", "cpu", flag] + UNPORTED[flag]
    with pytest.raises(NotImplementedError, match=re.escape(flag)):
        ttrain.main(argv)
    assert not (tmp_path / "ck").exists()
    assert unported_options(SEGANConfig()) == []
