"""The step's FLOP count (``step_flops``), MFU and ``--profile`` of the port
(``segan_pytorch_tpu_torch/utils/profiling.py``) on the CPU, at the toy width of
``tests/test_train.py``'s ``small_cfg``, and the pins of the two train flags and of
``bench``'s ``--steps_per_call`` to the repo's ``train.py`` and ``bench.py``.

``step_flops`` counts on a copy of the engine made of fake CPU tensors; here it is held to ``FlopCounterMode`` over a
real step on the plain route, to the same step with the kernel's plain version stubbed
out and its FLOPs added by formula (what a count on the card's route would need), and to
the JAX package's XLA count. The card's side (MFU in the loop and in ``bench``) is
``chip_smoke.py`` phase 10.
"""
import ast
import copy
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch import bench as tbench, train as ttrain
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import AEWSEGAN, WSEGAN
from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
from segan_pytorch_tpu_torch.utils import profiling
from segan_pytorch_tpu_torch.utils.config import SEGANConfig

ROOT = Path(__file__).resolve().parents[1]
# tests/test_train.py's small_cfg
SMALL = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
             z_dim=32, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16,
             batch_size=4)
ENGINES = {
    "segan": (SEGAN, {}),
    "segan_bf16": (SEGAN, dict(compute_dtype="bfloat16", no_bias=True)),
    "wsegan": (WSEGAN, dict(wsegan=True, gnorm_type="snorm", dnorm_type="snorm",
                            opt="adam", misalign_pair=True, interf_pair=True)),
    "aewsegan": (AEWSEGAN, dict(aewsegan=True, opt="adam")),
}
# the port's count over the JAX package's at small_cfg: XLA's cost analysis also counts
# the elementwise work, which FlopCounterMode does not (0.9475: 89.73 against 94.70 MFLOP)
JAX_RATIO = (0.9, 1.0)


def _engine(kind, **kw):
    cls, flags = ENGINES[kind]
    seg = cls(SEGANConfig(**{**SMALL, **flags, **kw}), device="cpu")
    seg.init_train()
    return seg


def _plain_step_flops(seg):
    """FlopCounterMode over one real step of a copy of the engine, on the plain route."""
    twin = copy.deepcopy(seg)
    B, T = seg.cfg.batch_size, seg.cfg.slice_size
    x = twin._inputs(*(torch.randn((B, T, 1) if k in ("clean", "noisy") else (B,))
                       for k in twin.batch_keys))
    draws = twin._draw(B, T)
    return profiling.count_flops(lambda: twin._body(x, twin._l1(100.0), draws))


@pytest.mark.parametrize("kind", list(ENGINES))
def test_step_flops_equals_the_counter_on_the_plain_route(kind):
    seg = _engine(kind)
    flops = seg.step_flops()
    assert flops == _plain_step_flops(seg) > 0
    assert seg.step_flops() is flops  # cached


@pytest.mark.parametrize("kind", ["segan", "wsegan", "aewsegan"])
def test_kernel_flops_by_formula_make_up_a_count_that_cannot_see_it(kind, monkeypatch):
    """On the card the encoder's convolutions run in the kernel, which no dispatch-level
    counter sees: a count with the plain version stubbed out (it records nothing) plus
    the kernel's 2 B T_out Cout Cin K per call equals step_flops()."""
    seg = _engine(kind)
    want = seg.step_flops()
    calls = []

    def stub(x, w, b, a, stride):
        B, cin, t_in = x.shape
        cout, _, k = w.shape
        t_out = (t_in - k) // stride + 1
        calls.append(2 * B * t_out * cout * cin * k)  # a multiply and an add per tap
        pre = torch.zeros((B, cout, t_out), dtype=x.dtype)
        return pre.clone(), pre

    monkeypatch.setattr(K, "conv1d_prelu_plain", stub)
    counted = _plain_step_flops(seg)
    n_enc = len(seg.G.enc_blocks) * (1 + (3 + 1 + 1 if kind == "wsegan" else 0))
    assert len(calls) == n_enc
    assert counted + sum(calls) == want and counted < want


def _snapshot(seg):
    out = {f"{n}": t.detach().clone() for m in (seg.G, seg.D) if m is not None
           for n, t in list(m.named_parameters()) + list(m.named_buffers())}
    for i, opt in enumerate(seg._optimizers()):
        out[f"opt{i}"] = copy.deepcopy(opt.state_dict())
    out["z"] = seg._z_train.get_state()
    out["phase"] = seg._phase_train.get_state()
    return out


@pytest.mark.parametrize("kind", ["segan", "wsegan"])
def test_step_flops_leaves_the_engine_untouched(kind):
    seg = _engine(kind)
    clean = np.random.RandomState(0).randn(4, 1024, 1).astype(np.float32)
    extra = [None] if kind == "wsegan" else []
    seg.train_step(clean, clean, None, *extra, 100.0)  # optimizer state to compare
    before, step = _snapshot(seg), seg.step
    seg.step_flops()
    after = _snapshot(seg)
    assert seg.step == step and before.keys() == after.keys()
    for k in before:
        if k.startswith("opt"):
            for i, st in before[k]["state"].items():
                assert all(torch.equal(v, after[k]["state"][i][n]) for n, v in st.items())
        else:
            assert torch.equal(before[k], after[k]), k
    assert all(p.device.type == "cpu" for p in seg.G.parameters())


def test_step_flops_against_jax(tmp_path):
    """Within 0.9-1.0 of the JAX package's XLA count of small_cfg's step at batch 4."""
    jseg = JaxSEGAN(JaxConfig(**SMALL, save_path=str(tmp_path)))
    jseg.init_state(batch_size=4)
    jseg.prepare_train(4)
    rng = np.random.RandomState(0)
    clean = (rng.randn(4, 1024, 1) * 0.1).astype(np.float32)
    import jax

    jseg.train_step(clean, clean, np.ones(4, np.float32), jax.random.PRNGKey(0), 100.0)
    want = jseg.step_flops()
    got = _engine("segan").step_flops()
    assert got == 89_726_976
    assert JAX_RATIO[0] <= got / want <= JAX_RATIO[1], got / want


def test_full_width_step_flops():
    """SEGAN+ at its script's width and batch: 35.76 GFLOP a slice, from the fake copy
    (no full-width step runs here)."""
    seg = SEGAN(SEGANConfig(no_bias=True, batch_size=300), device="cpu")
    assert seg.step_flops() == 10_727_719_526_400


def test_peak_flops_and_mfu(monkeypatch):
    assert profiling.peak_flops_per_chip() is None  # the CPU
    assert profiling.mfu(1e12, 1.0) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert profiling.peak_flops_per_chip() == 989e12
    assert profiling.mfu(10.728e12, 0.5) == pytest.approx(10.728e12 / 0.5 / 989e12)
    assert profiling.mfu(10.728e12, 0.5, n_chips=4) == pytest.approx(
        10.728e12 / 0.5 / 989e12 / 4)
    assert profiling.mfu(None, 0.5) is None and profiling.mfu(1e12, 0.0) is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Some Other GPU")
    assert profiling.peak_flops_per_chip() is None


def test_memory_stats_and_annotate_on_the_cpu(tmp_path):
    assert profiling.device_memory_stats() == {}
    with profiling.device_trace(str(tmp_path / "tr")):
        with profiling.annotate("the-range"):
            torch.ones(3).sum()
    (trace,) = (tmp_path / "tr").glob("trace_*.json")
    assert "the-range" in trace.read_text()


class _Batches:
    """`n` toy batches of 4 rows, the loader's fields."""

    def __init__(self, n):
        rng = np.random.RandomState(3)
        self.items = []
        for _ in range(n):
            c = (rng.randn(4, 1024) * 0.1).astype(np.float32)
            self.items.append({"clean": c, "noisy": c + 0.01, "mask": np.ones(4, np.float32),
                               "uttname": ["a"] * 4})

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter([dict(b) for b in self.items])


def test_profile_traces_the_first_epoch_and_forces_single_steps(tmp_path, capsys,
                                                                monkeypatch):
    cfg = SEGANConfig(**SMALL, no_bias=True, save_path=str(tmp_path), epoch=1, profile=True,
                      steps_per_call=4, no_train_gen=True)
    seg = SEGAN(cfg, device="cpu")
    monkeypatch.setattr(seg, "train_step_multi", lambda *a, **k: pytest.fail("grouped"))
    seg.train(cfg, _Batches(8), log_freq=1)
    out = capsys.readouterr().out
    assert "[!] --profile needs per-step dispatch; steps_per_call -> 1" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("(Iter")]
    assert len(lines) == 8 and seg.step == 8
    assert not any("mfu" in ln for ln in lines)  # no peak on the CPU
    assert f"[profile] device trace written to {tmp_path / 'profile'}" in out
    assert "[profile] memory: {}" in out
    assert list((tmp_path / "profile").glob("trace_*.json"))


def test_profile_log_line_carries_mfu_where_a_peak_is_known(tmp_path, capsys, monkeypatch):
    """From batch 3 on, the log line ends in the step's MFU (the peak monkeypatched in)."""
    monkeypatch.setattr(profiling, "peak_flops_per_chip", lambda: 1e9)
    cfg = SEGANConfig(**SMALL, no_bias=True, save_path=str(tmp_path), epoch=1, profile=True,
                      no_train_gen=True)
    seg = SEGAN(cfg, device="cpu")
    seg.train(cfg, _Batches(4), log_freq=1)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("(Iter")]
    assert ["mfu" in ln for ln in lines] == [False, False, True, True]
    assert re.search(r"mbtime: [\d.]+ s, mfu: [\d.]+%$", lines[-1]), lines[-1]
    # a first epoch shorter than the trace's 7 batches closes it at its end
    assert "[profile] device trace written to" in out


def test_profile_and_steps_per_call_through_the_cli(tmp_path):
    """Both flags reach the engine through ``python -m segan_pytorch_tpu_torch.train``;
    neither raises NotImplementedError any more."""
    from test_torch_data import write_pairs

    dirs = write_pairs(tmp_path / "d", [12000, 10000, 9000])
    argv = ["--clean_trainset", dirs[0], "--noisy_trainset", dirs[1], "--cache_dir",
            str(tmp_path / "c"), "--epoch", "1", "--device", "cpu", "--no_train_gen",
            "--batch_size", "4", "--slice_size", "4096", "--genc_fmaps", "8", "16",
            "--genc_poolings", "4", "4", "--z_dim", "16", "--denc_fmaps", "8", "16",
            "--denc_poolings", "4", "4", "--dpool_slen", "256", "--no_bias"]
    seg = ttrain.main(argv + ["--save_path", str(tmp_path / "a"), "--steps_per_call", "2",
                              "--profile"])
    assert seg.step == 3 and list((tmp_path / "a" / "profile").glob("trace_*.json"))
    opts = json.loads((tmp_path / "a" / "train.opts").read_text())
    assert opts["steps_per_call"] == 2 and opts["profile"] is True


def _root_parser_actions(path: Path, build: bool):
    """The argparse actions of the repo's `path`: its build_parser() (train.py), or the
    parser its main() builds before it parses (bench.py)."""
    spec = importlib.util.spec_from_file_location(f"root_{path.stem}", path)
    if build:
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return {a.dest: a for a in mod.build_parser()._actions}
    tree = ast.parse(path.read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "help")}
            out[node.args[0].value.lstrip("-")] = kw
    return out


def test_train_flags_are_train_py_s():
    root = _root_parser_actions(ROOT / "train.py", build=True)
    port = {a.dest: a for a in ttrain.build_parser()._actions}
    for dest in ("profile", "steps_per_call"):
        assert (port[dest].default, port[dest].type, type(port[dest]).__name__) == (
            root[dest].default, root[dest].type, type(root[dest]).__name__)
    assert port["profile"].help == root["profile"].help
    # the port's says what a call is here (a CUDA graph, not lax.scan) and leaves out the
    # TPU's measured gains
    want = root["steps_per_call"].help
    assert port["steps_per_call"].help.startswith(want.split(" (")[0])
    assert port["steps_per_call"].help.endswith("All engines; single-process.")
    assert "All engines; single-process." in want


def test_bench_steps_per_call_default_is_bench_py_s():
    root = _root_parser_actions(ROOT / "bench.py", build=False)
    port = {a.dest: a for a in tbench.build_parser()._actions}
    assert port["steps_per_call"].default == root["steps_per_call"]["default"] == 4


def test_bench_reports_steps_per_call_and_no_mfu_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "segan_pytorch_tpu_torch.bench", "--device", "cpu",
         "--preset", "tiny", "--steps", "1", "--warmup", "1", "--batch_size", "2",
         "--steps_per_call", "2", "--engine", "wsegan"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["steps_per_call"] == 2 and "mfu" not in res and res["value"] > 0
    assert (res["engine"], res["batch"], res["device"]) == ("wsegan", 2, "cpu")
