"""``segan_pytorch_tpu_torch/tools/serving_bench.py`` and ``tools/serving_soak.py`` on the
CPU: each starts ``python -m segan_pytorch_tpu_torch.serve --device cpu`` on a toy
checkpoint (slice 1024, fmaps 8/16/32, z_dim 32), drives it over HTTP and stops it. The
bench's JSON line has the root tool's keys and sane values; a short soak with reloads
every few seconds has at least one reload, no error on any path, monotonic counters, and
the root tool's report layout, with no card fields on the CPU. The server processes
are the tools' own, so nothing here runs JAX.
"""
import json
import socket

import pytest
import torch

from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.tools import serving_bench, serving_soak
from segan_pytorch_tpu_torch.utils.checkpoint import save_generator
from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts

TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], z_dim=32,
           no_bias=True)
BENCH_KEYS = [  # root tools/serving_bench.py's, in its order
    "metric", "utt_seconds", "enhance_p50_ms", "enhance_p90_ms", "enhance_rtf",
    "concurrency", "concurrent_wall_ms", "concurrent_device_passes", "coalesce_speedup",
    "stream_window", "stream_overlap", "stream_first_audio_ms", "stream_lag_p50_ms",
    "stream_lag_p90_ms", "stream_concurrency", "stream_conc_window_passes",
    "stream_conc_windows", "stream_windows_per_pass", "stream_conc_lag_p50_ms",
    "stream_conc_wall_ms"]
VERDICT_KEYS = ["rss_slope_kb_per_min", "rss_slope_last_third", "rss_slope_last_quarter",
                "rss_first_last_kb", "fd_drift", "thread_drift", "metrics_monotonic",
                "mono_violations", "errors"]
COUNT_KEYS = ["enhance_ok", "enhance_err", "stream_ok", "stream_err", "auth401",
              "auth_other", "reloads", "reload_err"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    work = tmp_path_factory.mktemp("served")
    cfg = SEGANConfig(**TOY)
    save_generator(build_generator(cfg, torch.Generator().manual_seed(0)),
                   str(work / "g.ckpt"))
    return work, str(work / "g.ckpt"), dump_train_opts(cfg, str(work / "opts"))


def test_serving_bench_on_the_cpu(toy, capsys):
    work, ckpt, opts = toy
    out = serving_bench.main(
        ["--g_ckpt", ckpt, "--cfg_file", opts, "--port", str(_free_port()), "--device",
         "cpu", "--dur", "1.0", "--reps", "3", "--concurrency", "3", "--window", "1024",
         "--stream_windows", "3", "--stream_concurrency", "2", "--warm_seconds", "0.1",
         "--log", str(work / "bench.log")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert list(out) == BENCH_KEYS
    assert out["metric"] == "serving_latency" and out["concurrency"] == 3
    assert 1 <= out["concurrent_device_passes"] <= 3
    assert out["enhance_p50_ms"] > 0 and out["stream_first_audio_ms"] > 0
    assert out["stream_conc_windows"] >= out["stream_conc_window_passes"] >= 1
    assert "Traceback" not in (work / "bench.log").read_text()


def test_serving_soak_on_the_cpu(toy, tmp_path):
    work, ckpt, opts = toy
    report = serving_soak.main(
        ["--g_ckpt", ckpt, "--cfg_file", opts, "--port", str(_free_port()), "--device",
         "cpu", "--minutes", "0.2", "--sample_s", "2", "--reload_s", "4", "--log",
         str(tmp_path / "soak.log"), "--out", str(tmp_path / "soak.json")])
    saved = json.loads((tmp_path / "soak.json").read_text())
    assert saved["counts"] == report["counts"] and len(saved["samples"]) == len(
        report["samples"])
    assert list(report) == ["duration_min", "samples", "counts", "verdicts"]
    assert list(report["verdicts"]) == VERDICT_KEYS
    assert list(report["counts"]) == COUNT_KEYS
    counts, v = report["counts"], report["verdicts"]
    assert counts["reloads"] >= 1 and counts["enhance_ok"] > 0 and counts["stream_ok"] > 0
    assert counts["auth401"] > 0
    assert v["errors"] == {"enhance_err": 0, "stream_err": 0, "auth_other": 0,
                           "reload_err": 0}
    assert v["metrics_monotonic"] and not v["mono_violations"]
    assert len(report["samples"]) >= 4
    for s in report["samples"]:
        assert {"t", "rss_kb", "threads", "fds", "metrics", "counts"} <= set(s)
        assert "card_memory_used_mib" not in s  # on the card only
    # the reloads reached the server's counter
    assert report["samples"][-1]["metrics"]["segan_reloads_total"] >= 1
