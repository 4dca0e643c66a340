"""The training loops with ``--steps_per_call`` S > 1 on the CPU, at toy width: the
counterparts of ``tests/test_train.py``'s loop tests of the JAX package (``TestWSEGANResume``
``test_*_loop_steps_per_call``, ``test_steps_per_call_groups_never_cross_epochs``).

S sub-steps per call equal S single steps bit for bit on the CPU, so a run with S > 1 must
log the same lines (without the times), write the same checkpoints with the same payloads
and resume into the same run as with S = 1; groups never cross an epoch's end, and the
ragged tail runs single steps. Batches that the loader cast to bf16 or fp16 take the same
path, up-cast exactly per sub-step.
"""
import contextlib
import io
import json
import re
import shutil

import numpy as np
import pytest
import torch

from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import AEWSEGAN, WSEGAN
from segan_pytorch_tpu_torch.utils.config import SEGANConfig

TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
           z_dim=32, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16,
           batch_size=2, no_train_gen=True)
ENGINES = {
    "segan": (SEGAN, dict(no_bias=True)),
    "wsegan": (WSEGAN, dict(wsegan=True, gnorm_type="snorm", dnorm_type="snorm", opt="adam",
                            misalign_pair=True)),
    "aewsegan": (AEWSEGAN, dict(aewsegan=True, opt="adam")),
}
TIMES = re.compile(r"btime: [\d.]+ s, mbtime: [\d.]+ s")


class FakeLoader:
    """`n` batches of 2 rows an epoch, the same each epoch, the last with one row masked;
    utterance names make the second row of each 'additive'. With `dtype`, clean and
    noisy come as CPU tensors of that dtype, as the loader emits them under
    ``--loader_dtype``; with `rounded_to`, as fp32 arrays of the values rounded to it."""

    def __init__(self, n, B=2, T=1024, dtype=None, rounded_to=None):
        rng = np.random.RandomState(n)
        self.items = []
        for i in range(n):
            c = (rng.randn(B, T) * 0.1).astype(np.float32)
            mask = np.ones(B, np.float32)
            if i == n - 1:
                mask[-1] = 0.0
            item = {"clean": c, "noisy": c + (rng.randn(B, T) * 0.02).astype(np.float32),
                    "mask": mask, "uttname": ["a", "a_additive"]}
            for k in ("clean", "noisy"):
                if dtype is not None:
                    item[k] = torch.from_numpy(item[k]).to(getattr(torch, dtype))
                elif rounded_to is not None:
                    item[k] = torch.from_numpy(item[k]).to(getattr(torch, rounded_to)) \
                        .float().numpy()
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter([dict(b) for b in self.items])


def _run(kind, tmp, S, epoch, n_batches, log_freq, resume_from=None, loader_kw=None,
         **kw):
    cls, flags = ENGINES[kind]
    cfg = SEGANConfig(**TOY, **flags, save_path=str(tmp), epoch=epoch, steps_per_call=S,
                      **kw)
    seg = cls(cfg, device="cpu")
    if resume_from is not None:
        seg.resume(str(resume_from))
    calls = []
    multi = seg.train_step_multi

    def counted(*a, **k):
        calls.append(len(k["l1_w_s"]))
        return multi(*a, **k)

    seg.train_step_multi = counted
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        seg.train(cfg, FakeLoader(n_batches, **(loader_kw or {})), l1_init=100.0,
                  l1_dec_step=0.5,
                  l1_dec_epoch=1, log_freq=log_freq)
    lines = [TIMES.sub("", ln) for ln in out.getvalue().splitlines()
             if ln.startswith(("(Iter", "Iter"))]
    return seg, lines, calls


def _payloads(tmp):
    out = {}
    for index in sorted(p.name for p in tmp.iterdir() if p.name.endswith("checkpoints")):
        out[index] = json.loads((tmp / index).read_text())
        for name in out[index]["latest"]:
            out[name] = torch.load(tmp / f"weights_{name}", weights_only=True)
    return out


def _same(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_loop_with_steps_per_call_is_the_single_step_loop(kind, S, tmp_path):
    """Two epochs, a log point every S batches: the same log lines (losses, L1 weights,
    iterations), the same checkpoints bit for bit, and groups of S. SEGAN's five batches
    an epoch end in a ragged tail of single steps; the WSEGAN loops log by iteration
    across epochs, so theirs take four, where S = 1 logs at the same iterations."""
    n = 5 if kind == "segan" else 4
    one, lines1, calls1 = _run(kind, tmp_path / "one", 1, 2, n, S)
    many, lines, calls = _run(kind, tmp_path / "many", S, 2, n, S)
    assert calls1 == [] and calls == [S] * (2 * (n // S))
    assert lines == lines1 and len(lines) >= 2
    assert many.step == one.step == 2 * n
    a, b = _payloads(tmp_path / "one"), _payloads(tmp_path / "many")
    assert a.keys() == b.keys() and len(a) >= 2
    for k in a:
        assert _same(a[k], b[k]), k
    if kind == "segan":  # the L1 weight decayed once per sub-step: 100 - 10 x 0.5
        assert "l1_w: 95.00" in lines[-1]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_steps_per_call_takes_cast_batches(kind, dtype, tmp_path):
    """Batches cast by the loader (``--loader_dtype``), four an epoch: S = 2 logs and
    saves what S = 1 does on the same cast batches, and both what single steps on fp32
    batches of the rounded values do: each sub-step's batch is up-cast exactly."""
    ref, lines_ref, _ = _run(kind, tmp_path / "fp32", 1, 1, 4, 2,
                             loader_kw=dict(rounded_to=dtype))
    one, lines1, calls1 = _run(kind, tmp_path / "one", 1, 1, 4, 2, loader_kw=dict(dtype=dtype))
    many, lines, calls = _run(kind, tmp_path / "many", 2, 1, 4, 2, loader_kw=dict(dtype=dtype))
    assert calls1 == [] and calls == [2, 2]
    assert lines == lines1 == lines_ref and len(lines) == 2
    assert many.step == one.step == ref.step == 4
    want = _payloads(tmp_path / "fp32")
    for got in (_payloads(tmp_path / "one"), _payloads(tmp_path / "many")):
        assert got.keys() == want.keys() and len(want) >= 2
        for k in want:
            assert _same(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["segan", "wsegan"])
def test_resume_with_steps_per_call_continues_the_run(kind, tmp_path):
    """One epoch with S = 2, then --resume to the third with S = 2 and, from a copy of
    the same checkpoints, with S = 1: the same run, bit for bit."""
    _run(kind, tmp_path / "a", 2, 1, 5, 2)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    resumed, _, calls = _run(kind, tmp_path / "a", 2, 3, 5, 2, resume_from=tmp_path / "a")
    single, _, _ = _run(kind, tmp_path / "b", 1, 3, 5, 2, resume_from=tmp_path / "b")
    assert resumed.step == single.step == 15 and calls == [2, 2] * 2
    for side in ("G", "D"):
        sa, sb = getattr(resumed, side).state_dict(), getattr(single, side).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), side


@pytest.mark.parametrize("kind", list(ENGINES))
def test_odd_budget_ends_in_single_steps(kind, tmp_path):
    """Three batches an epoch, three epochs (9 steps, odd): a group and a single step an
    epoch; the counter lands on the budget."""
    seg, _, calls = _run(kind, tmp_path, 2, 3, 3, 4)
    assert seg.step == 9 and calls == [2] * 3


@pytest.mark.parametrize("kind", ["segan", "wsegan"])
def test_groups_never_cross_an_epoch(kind, tmp_path):
    """S = 4 with two batches an epoch: every step is single, and every epoch keeps its
    end-of-epoch checkpoint at its step (WSEGAN's named after the steps taken, SEGAN's
    after the iteration)."""
    seg, _, calls = _run(kind, tmp_path, 4, 2, 2, 10)
    assert seg.step == 4 and calls == []
    names = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("weights_EOE_G"))
    first = 2 if kind == "wsegan" else 3
    assert names == [f"weights_EOE_G-Generator-{first}.ckpt",
                     f"weights_EOE_G-Generator-{first + 2}.ckpt"], names
