"""The port's user tools against the repo's root tools, on the CPU: every parser pinned to
its root tool's (option for option; root's ``--cpu`` becomes ``--device {cuda,cpu}``,
default cuda, and every tool that builds G or starts a server gains it), then
``eval_noisy_performance`` (the logfile byte for byte, a missing reference exits
non-zero as root's does), ``tools/make_demo_corpus`` (all three styles, every wav byte
for byte) and ``tools/train_throughput_bench`` (``LOG_RE`` and ``steady_state`` on
``tests/test_tools.py``'s three cases, and one toy-width run of the port's trainer).

Root tools run in this process (``runpy`` with ``sys.argv`` patched), so their imports of
the JAX package cost nothing more; their parsers are captured from their ``main()``.
"""
import argparse
import importlib.util
import json
import os
import runpy
import sys
import tempfile
from pathlib import Path

import pytest

from segan_pytorch_tpu_torch import eval_noisy_performance, weight_converter
from segan_pytorch_tpu_torch.tools import (ab_parity, make_demo_corpus, serving_bench,
                                           serving_soak, train_throughput_bench)

ROOT = Path(__file__).resolve().parents[1]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices,
                     type(a).__name__) for a in parser._actions if a.dest != "help"}


def _root_module(rel):
    spec = importlib.util.spec_from_file_location("root_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _root_parser(rel, monkeypatch):
    """The parser that root tool `rel` builds in its main() and parses with at once."""
    class Built(Exception):
        pass

    def capture(self, *a, **k):
        raise Built(self)

    # root serving_soak.py sets SEGAN_TPU_PLATFORM at import: keep it to this test
    monkeypatch.setenv("SEGAN_TPU_PLATFORM", "cpu")
    mod = _root_module(rel)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Built) as ei:
        mod.main()
    monkeypatch.undo()
    return ei.value.args[0]


DEVICE = ("--device",), "cuda", None, None, ("cuda", "cpu"), "_StoreAction"
# root file: the port's parser, root options it drops, and the port's defaults where
# they differ: the start-up timeouts (the card has no TPU compile to wait for), the
# server logs (in the temp directory, not /tmp) and the soak's report (not root's
# tools/r5_serving_soak.json)
PARSERS = {
    "eval_noisy_performance.py": (eval_noisy_performance.build_parser, (), {}),
    "weight_converter.py": (weight_converter.build_parser, (), {}),
    "tools/make_demo_corpus.py": (make_demo_corpus.build_parser, (), {}),
    "tools/ab_parity.py": (ab_parity.build_parser, (), {}),
    "tools/serving_bench.py": (serving_bench.build_parser, ("cpu",), dict(
        startup_timeout=180, log=os.path.join(tempfile.gettempdir(),
                                              "serving_bench_server.log"))),
    "tools/serving_soak.py": (serving_soak.build_parser, ("cpu",), dict(
        startup_timeout=180, out="serving_soak.json",
        log=os.path.join(tempfile.gettempdir(), "serving_soak_server.log"))),
    "tools/train_throughput_bench.py": (train_throughput_bench.build_parser, (), {}),
}
BUILDS_G = {"tools/ab_parity.py", "tools/serving_bench.py", "tools/serving_soak.py",
            "tools/train_throughput_bench.py"}


@pytest.mark.parametrize("rel", list(PARSERS))
def test_parser_equals_the_root_tool(rel, monkeypatch):
    build, dropped, new_default = PARSERS[rel]
    want, got = _options(_root_parser(rel, monkeypatch)), _options(build())
    if "cpu" in want:  # root's --cpu (serving_soak's can never be turned off)
        assert want["cpu"][5] == "_StoreTrueAction"
    for k in dropped:
        del want[k]
    added = {"device"} if rel in BUILDS_G else set()
    assert set(got) - set(want) == added and set(want) <= set(got)
    if added:
        assert got["device"] == DEVICE
    for k, w in want.items():
        if k in new_default:
            assert got[k][:1] + got[k][2:] == w[:1] + w[2:], k
            assert got[k][1] == new_default[k], k
        else:
            assert got[k] == w, k
    # the order of the options, --help's
    assert [k for k in got if k in want] == list(want)


# -- make_demo_corpus -----------------------------------------------------------------
def _root_run(rel, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [rel, *argv])
    runpy.run_path(str(ROOT / rel), run_name="__main__")


def _tree_bytes(d: Path):
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*.wav"))}


@pytest.mark.parametrize("style", ["v1", "v2", "whisper"])
def test_demo_corpus_equals_the_root_tool(style, tmp_path, monkeypatch):
    argv = ["--n_train", "2", "--n_test", "1", "--dur", "0.5", "--seed", "7",
            "--style", style]
    _root_run("tools/make_demo_corpus.py", ["--out", str(tmp_path / "root"), *argv],
              monkeypatch)
    make_demo_corpus.main(["--out", str(tmp_path / "port"), *argv])
    want, got = _tree_bytes(tmp_path / "root"), _tree_bytes(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == 6
    assert got == want


# -- eval_noisy_performance -------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("corpus")
    make_demo_corpus.main(["--out", str(out), "--n_train", "0", "--n_test", "3",
                           "--dur", "1.0", "--style", "v2"])
    return out


def test_eval_logfile_equals_the_root_tool(corpus, tmp_path, monkeypatch, capsys):
    dirs = ["--test_wavs", str(corpus / "noisy_testset"), "--clean_wavs",
            str(corpus / "clean_testset")]
    _root_run("eval_noisy_performance.py", [*dirs, "--logfile", str(tmp_path / "root.log")],
              monkeypatch)
    root_out = capsys.readouterr().out
    means = eval_noisy_performance.main([*dirs, "--logfile", str(tmp_path / "port.log")])
    port_out = capsys.readouterr().out
    text = (tmp_path / "port.log").read_bytes()
    assert text == (tmp_path / "root.log").read_bytes()
    lines = text.decode().splitlines()
    assert lines[0] == "FILE CSIG CBAK COVL PESQ SSNR" and len(lines) == 4
    # the printed means too (the per-file timings aside)
    tail = [ln for ln in port_out.splitlines() if ln.startswith(("===", "mean"))]
    assert tail == [ln for ln in root_out.splitlines() if ln.startswith(("===", "mean"))]
    assert tail[1] == f"mean CSIG: {means['csig']:.4f}"


def test_eval_missing_reference_exits_as_the_root_tool(corpus, tmp_path, monkeypatch):
    clean = tmp_path / "clean"
    clean.mkdir()
    for p in sorted((corpus / "clean_testset").glob("*.wav"))[:2]:
        (clean / p.name).write_bytes(p.read_bytes())
    argv = ["--test_wavs", str(corpus / "noisy_testset"), "--clean_wavs", str(clean),
            "--logfile", str(tmp_path / "x.log")]
    with pytest.raises(SystemExit) as root_exit:
        _root_run("eval_noisy_performance.py", argv, monkeypatch)
    with pytest.raises(SystemExit) as port_exit:
        eval_noisy_performance.main(argv)
    assert port_exit.value.code == root_exit.value.code
    assert "no clean reference for utt_testset_0002.wav" in str(port_exit.value.code)
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no wavs found"):
        eval_noisy_performance.main(["--test_wavs", str(tmp_path / "empty"),
                                     "--clean_wavs", str(clean), "--logfile",
                                     str(tmp_path / "y.log")])


# -- train_throughput_bench -----------------------------------------------------------
def test_log_re_and_steady_state_equal_the_root_tool():
    """``tests/test_tools.py``'s three cases on both modules, and the port's own log
    line (``models/segan.py``) matched."""
    root = _root_module("tools/train_throughput_bench.py")
    port = train_throughput_bench
    assert port.LOG_RE.pattern == root.LOG_RE.pattern
    line = ("(Iter 196) Batch 14/14 (Epoch 14) d_real:0.3458, d_fake:0.1781,"
            " g_adv:0.2010, g_l1:0.6792 l1_w: 100.00, btime: 0.0024 s,"
            " mbtime: 3.3281 s")
    for mod in (root, port):
        assert tuple(map(int, mod.LOG_RE.search(line).groups())) == (196, 14, 14, 14)
    marks = [(100.0, 14, 1), (110.0, 28, 2), (120.0, 42, 3), (130.0, 56, 4)]
    assert port.steady_state(marks, 1, 300) == root.steady_state(marks, 1, 300) == (
        28 * 300 / 20.0, 28, 20.0)
    for mod in (root, port):
        with pytest.raises(ValueError):
            mod.steady_state([(10.0, 14, 1), (20.0, 28, 2)], skip_epochs=2, batch_size=300)
        with pytest.raises(ValueError, match="degenerate"):
            mod.steady_state([(10.0, 14, 3), (10.0, 28, 4)], skip_epochs=2, batch_size=300)
    src = (ROOT / "segan_pytorch_tpu_torch/models/segan.py").read_text()
    assert 'f"(Iter {iteration}) Batch {bidx}/{num_batches} (Epoch {epoch})"' in src


TOY = ["--slice_size", "4096", "--genc_fmaps", "8", "16", "--genc_poolings", "4", "4",
       "--z_dim", "16", "--denc_fmaps", "8", "16", "--denc_poolings", "4", "4",
       "--dpool_slen", "256"]


def test_train_throughput_bench_runs_the_port_trainer(tmp_path, capsys):
    """Three epochs of the port's CLI at toy width on the CPU, the first skipped: the
    JSON line has the root tool's keys, and its window is epochs 2-3."""
    make_demo_corpus.main(["--out", str(tmp_path / "c"), "--n_train", "2", "--n_test", "0",
                           "--dur", "1.0"])
    out = train_throughput_bench.main(
        ["--corpus", str(tmp_path / "c"), "--batch_size", "4", "--epoch", "3",
         "--skip_epochs", "1", "--steps_per_call", "2", "--save_path", str(tmp_path / "s"),
         "--device", "cpu", "--extra", *TOY])
    printed = capsys.readouterr().out
    assert json.loads(printed.strip().splitlines()[-1]) == out
    assert "--device cpu" in printed and "segan_pytorch_tpu_torch.train" in printed
    nb = out["num_batches_per_epoch"]
    assert out["steady_state_steps"] == nb and out["value"] > 0
    assert out["device_only_slices_per_sec"] is None
    assert set(out) == {
        "metric", "value", "unit", "batch_size", "steps_per_call", "loader_dtype",
        "io_threads", "steady_state_steps", "steady_state_wall_s", "total_wall_s",
        "num_batches_per_epoch", "h2d_bytes_per_slice", "h2d_mb_per_sec_at_rate",
        "device_only_slices_per_sec", "note_ragged_tail"}
    # --eoe_save_every 0: every epoch // 2 = 1 epochs, each named after the next iteration
    assert {p.name for p in (tmp_path / "s").glob("weights_EOE_G-*.ckpt")} == {
        f"weights_EOE_G-Generator-{e * nb + 1}.ckpt" for e in (1, 2, 3)}
