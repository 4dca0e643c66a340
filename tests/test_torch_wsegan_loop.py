"""The port's WSEGAN and AEWSEGAN training loops (``WSEGAN.train``, ``AEWSEGAN.train``)
against the JAX package's at toy width on a synthetic corpus, on the CPU.

With the train step stubbed in both packages (it records what it is given and returns
fixed losses) the loops must feed the same batches, additive masks and L1 weights, log
the same iterations, write the same checkpoint names and indices, and, resumed, run only
the iterations left. A WSEGAN checkpoint is named after the steps taken (the loop starts
at the step count), so the payload's step equals the number in its name, unlike SEGAN's.
"""
import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import jax

from segan_pytorch_tpu.data import DataLoader as JaxLoader, SEDataset as JaxDataset
from segan_pytorch_tpu.models.wsegan import AEWSEGAN as JaxAEWSEGAN, WSEGAN as JaxWSEGAN
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.data.loader import DataLoader
from segan_pytorch_tpu_torch.data.se_dataset import SEDataset
from segan_pytorch_tpu_torch.models.wsegan import AEWSEGAN, WSEGAN, additive_mask
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import write_pairs

TOY = dict(slice_size=4096, genc_fmaps=[8, 16], genc_poolings=[4, 4], z_dim=16,
           denc_fmaps=[8, 16], denc_poolings=[4, 4], dpool_slen=256, batch_size=4,
           gnorm_type="snorm", dnorm_type="snorm", opt="adam", misalign_pair=True,
           no_train_gen=True)
WS_METRICS = {"d_loss": 0.25, "g_loss": 0.5, "g_adv": 0.75, "pow_loss": 1.0,
              "den_loss": 1.25, "d_real": 0.1, "d_fake": 0.2, "d_fake_shuf": 0.3}
WS_LOG = re.compile(r"^Iter \d+/\d+ \(\d+ bpe\) d_loss:\S+, g_loss: \S+, pow_loss: \S+, "
                    r"den_loss: \S+", re.M)
AE_LOG = re.compile(r"^Iter \d+/\d+ \(\d+ bpe\) g_l2_loss:\S+,", re.M)
SDS = [3.0, 2.0, 2.5, 1.0, 4.0, 0.5]  # evaluate_sd's readings: better, worse, better...


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """10 training slices of three utterances (batches of 4: the third ragged), the
    second named as an 'additive' one; 5 validation slices."""
    root = tmp_path_factory.mktemp("wsloop")
    train = write_pairs(root / "train", [12000, 10000, 9000])
    for d in train:
        os.rename(os.path.join(d, "utt1.wav"), os.path.join(d, "utt1_additive.wav"))
    valid = write_pairs(root / "valid", [8192, 8000], seed=1)
    return train, valid, root


def _loader(pkg, dirs, cache, batch=4):
    ds_cls, dl_cls = (JaxDataset, JaxLoader) if pkg == "jax" else (SEDataset, DataLoader)
    ds = ds_cls(*dirs, 0.95, cache_dir=str(cache), slice_size=4096, slice_workers=1)
    return dl_cls(ds, batch_size=batch, shuffle=True, num_workers=1, seed=5)


def _engine(pkg, family, save, **kw):
    cfg = dict(TOY, save_path=str(save), **{family: True}, **kw)
    if pkg == "jax":
        seg = {"wsegan": JaxWSEGAN, "aewsegan": JaxAEWSEGAN}[family](JaxConfig(**cfg))
        seg.init_state(jax.random.PRNGKey(0), batch_size=4)
        return seg
    return {"wsegan": WSEGAN, "aewsegan": AEWSEGAN}[family](SEGANConfig(**cfg),
                                                          device="cpu")


def _stub(pkg, seg, family, calls, sds):
    """Replace the engine's step (and evaluate_sd) by a recorder with fixed losses."""
    metrics = WS_METRICS if family == "wsegan" else {"loss": 0.5}
    if pkg == "jax":
        def step(clean, noisy, mask, *rest):
            amask = np.asarray(rest[0]) if family == "wsegan" else None
            calls.append((np.asarray(clean), np.asarray(mask), amask, rest[-1]))
            return dict(metrics), np.zeros(np.shape(clean), np.float32), None
    else:
        def step(clean, noisy, mask=None, *rest, **kw):
            amask = rest[0].numpy() if family == "wsegan" else None
            calls.append((clean.numpy(), mask.numpy(), amask, rest[-1]))
            seg.step += 1
            return ({k: torch.tensor(v) for k, v in metrics.items()},
                    torch.zeros_like(clean), None)
    seg.train_step = step
    seg.evaluate_sd = lambda cfg, dloader, max_samples=1: sds.append(SDS[len(sds)]) or sds[-1]


def _stubbed_run(pkg, family, corpus, save, epoch, resume=False, val=False):
    seg = _engine(pkg, family, save, epoch=epoch)
    if resume:
        with contextlib.redirect_stdout(io.StringIO()):
            seg.resume(str(save))
    calls, sds = [], []
    _stub(pkg, seg, family, calls, sds)
    dl = _loader(pkg, corpus[0], save.parent / f"cache-{pkg}")
    va = _loader(pkg, corpus[1], save.parent / f"vcache-{pkg}", batch=300) if val else None
    out = io.StringIO()
    args = (seg.cfg, dl) + ((None,) if pkg == "jax" else ())
    with contextlib.redirect_stdout(out):
        seg.train(*args, l1_init=100.0, l1_dec_step=0.5, l1_dec_epoch=1, log_freq=2,
                  va_dloader=va)
    log = (WS_LOG if family == "wsegan" else AE_LOG).findall(out.getvalue())
    return dict(calls=calls, log=log, sds=sds, seg=seg)


def _files(save):
    names = sorted(p.name for p in save.iterdir() if p.name.startswith("weights_"))
    indices = {p.name: json.loads(p.read_text()) for p in save.iterdir()
               if p.name.endswith("checkpoints")}
    return names, indices


@pytest.fixture(scope="module")
def wsegan_runs(corpus, tmp_path_factory):
    """Per package: two epochs, then a resumed run to epoch 3, each with its save dir."""
    out = {}
    for pkg in ("jax", "port"):
        save = tmp_path_factory.mktemp(f"ws-{pkg}") / "ck"
        first = _stubbed_run(pkg, "wsegan", corpus, save, epoch=2)
        first["files"] = _files(save)
        second = _stubbed_run(pkg, "wsegan", corpus, save, epoch=3, resume=True)
        second["files"] = _files(save)
        out[pkg] = (first, second, save)
    return out


def test_wsegan_loop_feeds_the_same_batches_masks_and_l1(wsegan_runs):
    """Six iterations (two epochs of 3 batches, drawn on without end): the same batches,
    masks and additive masks, and the L1 weight fixed at l1_init (no decay)."""
    for run in (0, 1):
        jcalls = wsegan_runs["jax"][run]["calls"]
        tcalls = wsegan_runs["port"][run]["calls"]
        assert len(tcalls) == len(jcalls) == (6, 3)[run]
        for (jc, jm, ja, jl), (tc, tm, ta, tl) in zip(jcalls, tcalls):
            assert tc.shape == (4, 4096, 1) and np.array_equal(jc, tc)
            assert np.array_equal(jm, tm) and np.array_equal(ja, ta) and jl == tl == 100.0
    tcalls = wsegan_runs["port"][0]["calls"]
    assert [c[1].tolist() for c in tcalls[:3]] == [[1] * 4, [1] * 4, [1, 1, 0, 0]]
    amasks = np.concatenate([c[2] for c in tcalls])
    assert 0 < amasks.sum() < amasks.size  # utt1_additive's slices, and only those


def test_wsegan_loop_logs_and_saves_as_jax(wsegan_runs):
    """The same log lines at every second iteration, the same EOE G and D names after
    the steps taken and the same indices; the resumed run goes on from iteration 7."""
    for run in (0, 1):
        jr, tr = wsegan_runs["jax"][run], wsegan_runs["port"][run]
        assert tr["log"] == jr["log"]
        assert tr["files"] == jr["files"]
    first, second, save = wsegan_runs["port"]
    assert first["log"][0] == ("Iter 2/6 (3 bpe) d_loss:0.2500, g_loss: 0.5000, "
                               "pow_loss: 1.0000, den_loss: 1.2500")
    assert [line.split(" ", 2)[1] for line in second["log"]] == ["8/9"]
    names, indices = second["files"]
    assert indices["EOE_G-checkpoints"]["latest"] == [
        "EOE_G-Generator-3.ckpt", "EOE_G-Generator-6.ckpt", "EOE_G-Generator-9.ckpt"]
    assert "weights_EOE_D-Discriminator-9.ckpt" in names
    # the payload's step is the steps taken, the number in the name: a resume runs on
    # from there, as the JAX engine does
    payload = torch.load(save / "weights_EOE_G-Generator-6.ckpt", weights_only=True)
    assert payload["step"] == 6 and "optimizer" in payload
    assert second["seg"].step == 9


@pytest.fixture(scope="module")
def aewsegan_runs(corpus, tmp_path_factory):
    out = {}
    for pkg in ("jax", "port"):
        save = tmp_path_factory.mktemp(f"ae-{pkg}") / "ck"
        run = _stubbed_run(pkg, "aewsegan", corpus, save, epoch=4, val=True)
        run["files"] = _files(save)
        out[pkg] = run
    return out


def test_aewsegan_loop_logs_scores_and_saves_as_jax(aewsegan_runs):
    """Twelve G steps: log lines every second one, evaluate_sd at each (six readings),
    the best ones saved under 'AEWSEGAN-G-' and the EOE G at each epoch's end, with the
    same names and indices; no D anywhere."""
    j, t = aewsegan_runs["jax"], aewsegan_runs["port"]
    assert len(t["calls"]) == len(j["calls"]) == 12
    for (jc, jm, _, jl), (tc, tm, _, tl) in zip(j["calls"], t["calls"]):
        assert np.array_equal(jc, tc) and np.array_equal(jm, tm) and jl == tl == 100.0
    assert t["log"] == j["log"] and len(t["log"]) == 6
    assert t["sds"] == j["sds"] == SDS
    assert t["files"] == j["files"]
    names, indices = t["files"]
    assert indices["AEWSEGAN-G-checkpoints"]["latest"] == [
        "AEWSEGAN-G-best_Generator-2.ckpt", "AEWSEGAN-G-best_Generator-4.ckpt",
        "AEWSEGAN-G-best_Generator-8.ckpt", "AEWSEGAN-G-best_Generator-12.ckpt"]
    assert indices["EOE_G-checkpoints"]["current"] == "EOE_G-Generator-12.ckpt"
    assert not any("Discriminator" in n for n in names)


def test_additive_mask_reads_the_utterance_names():
    np.testing.assert_array_equal(additive_mask(["a", "b_additive", "additive_c"]),
                                  np.array([0.0, 1.0, 1.0], np.float32))
