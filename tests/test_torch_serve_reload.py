"""The port's ``POST /admin/reload`` and its generations, and TLS and mutual TLS, with
``--device cpu`` at toy width, against the repo's ``serve.py`` contract (``tests/
test_serve.py``'s ``TestServeOps``, ``test_tls`` and ``TestServeMutualTLS``): 500 on a
bad checkpoint with the old engine answering bit for bit, 400 and 401, the swap to the
new engine's answers (and to a WSEGAN engine by its ``cfg_file``), the reloaded engine
against the JAX engine on the same checkpoint, counters that never go back, retirement
(``RETIRE_SECONDS`` shortened) and ``close()``, the reload probe's CPU run, the parser's
TLS errors, HTTPS, and a client without a certificate refused under mutual TLS.

The servers run in this process (``build_server`` and ``serve_forever`` on a thread).
"""
import gc
import io
import json
import shutil
import ssl
import subprocess
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from segan_pytorch_tpu_torch import serve
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
from segan_pytorch_tpu_torch.tools import reload_leak_probe
from segan_pytorch_tpu_torch.utils import serving
from test_torch_serve import (SELF_TOL, Server, _checkpoint, _error, _get_json, _metrics,
                              _pcm, _post, _prep, _seed_z, _stream, _wav_bytes)

COUNTERS = ("segan_requests_total", "segan_device_passes_total",
            "segan_stream_window_passes_total", "segan_stream_windows_total",
            "segan_reloads_total", "segan_enhance_seconds_sum")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two SEGAN+ checkpoints of other weights (A, B) and a WSEGAN one, each
    (ckpt, train.opts, cfg)."""
    out = {}
    for name, kw in (("A", {"no_bias": True}), ("B", {"no_bias": True}),
                     ("W", {"gnorm_type": "snorm", "wsegan": True})):
        (tmp_path_factory.getbasetemp() / f"reload_{name}").mkdir()
        out[name] = _checkpoint(tmp_path_factory.getbasetemp() / f"reload_{name}", **kw)
    with torch.no_grad():  # B's weights differ from A's (one seed built both)
        sd = torch.load(str(out["B"][0]), weights_only=False)
        g = torch.Generator().manual_seed(99)
        for k, v in sd["state_dict"].items():
            if k.endswith("weight") and v.ndim == 3:
                v.mul_(1.0 + 0.2 * torch.rand(v.shape, generator=g))
        torch.save(sd, str(out["B"][0]))
    return out


def _engine(ckpt, cfg):
    seg = SEGAN(cfg, device="cpu")
    seg.g_load_pretrained(str(ckpt))
    return seg


def _reload(base, body, headers=None):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    return json.loads(_post(base, "/admin/reload", data, headers, timeout=120)[2])


def _answer(base, body, seed):
    return wavfile.read(io.BytesIO(_post(base, f"/enhance?seed={seed}", body)[2]))[1]


@pytest.fixture
def short_retire(monkeypatch):
    monkeypatch.setattr(serve, "RETIRE_SECONDS", 0.2)


def _wait_retired(state, timeout=30):
    for t in state["retiring"]:
        t.join(timeout=timeout)
        assert not t.is_alive()


# -- the reload ------------------------------------------------------------------------
def test_bad_checkpoint_is_500_and_the_old_engine_answers_bit_for_bit(ckpts, tmp_path):
    ckpt, opts, _ = ckpts["A"]
    s = Server(ckpt, opts)
    try:
        body = _wav_bytes(n=2048, seed=3)
        before = _post(s.base, "/enhance?seed=9", body)[2]
        gen = s.state["gen"]
        bad = tmp_path / "bad.ckpt"
        bad.write_bytes(b"not a checkpoint")
        for path in ("/nonexistent/g.ckpt", str(bad)):
            err = _error(s.base, "/admin/reload", json.dumps({"g_ckpt": path}).encode())
            assert err.code == 500 and "reload failed" in json.loads(err.read())["error"]
        assert s.state["gen"] is gen and s.state["reloads"] == 0
        assert _post(s.base, "/enhance?seed=9", body)[2] == before
        assert _get_json(s.base, "/healthz")["reloads"] == 0
    finally:
        s.stop()


@pytest.mark.parametrize("body", [b"not json", b"{}", b'{"cfg_file": "train.opts"}',
                                  b'{"g_ckpt": ""}', b"[1, 2]"])
def test_bad_json_or_missing_g_ckpt_is_400(ckpts, body):
    ckpt, opts, _ = ckpts["A"]
    s = Server(ckpt, opts)
    try:
        err = _error(s.base, "/admin/reload", body)
        assert err.code == 400, body
        assert s.state["reloads"] == 0 and _get_json(s.base, "/healthz")["status"] == "ok"
    finally:
        s.stop()


def test_reload_requires_the_token(ckpts, short_retire):
    (ckpt, opts, _), (ckpt_b, _, _) = ckpts["A"], ckpts["B"]
    s = Server(ckpt, opts, "--auth_token", "tok")
    try:
        body = json.dumps({"g_ckpt": str(ckpt_b)}).encode()
        for hdrs in ({}, {"Authorization": "Bearer nope"}):
            err = _error(s.base, "/admin/reload", body, hdrs)
            assert err.code == 401 and err.headers["WWW-Authenticate"] == "Bearer"
        assert s.state["reloads"] == 0
        info = _reload(s.base, body, {"Authorization": "Bearer tok"})
        assert info["status"] == "reloaded" and info["reloads"] == 1
    finally:
        s.stop()


def test_reload_swaps_to_the_new_engine_on_the_servers_device(ckpts, short_retire,
                                                              monkeypatch):
    """After the swap an answer is the new engine's generate() with the seed's z, built
    on the server's device (the engine builder defaults to CUDA), and no longer the old
    engine's."""
    (ckpt, opts, cfg), (ckpt_b, _, cfg_b) = ckpts["A"], ckpts["B"]
    devices = []
    build = serve.build_generation

    def recorded(state, cfg_file, g_ckpt):
        devices.append(state["device"])
        return build(state, cfg_file, g_ckpt)

    monkeypatch.setattr(serve, "build_generation", recorded)
    s = Server(ckpt, opts)
    try:
        body = _wav_bytes(n=2500, seed=4)
        old = _answer(s.base, body, 11)
        info = _reload(s.base, {"g_ckpt": str(ckpt_b)})
        assert info == {"status": "reloaded", "g_ckpt": str(ckpt_b), "reloads": 1,
                        "seconds": info["seconds"]}
        assert set(info["seconds"]) == {"load", "warm", "warm_generate"}
        assert 0 < info["seconds"]["warm_generate"] <= info["seconds"]["warm"]
        assert devices == [torch.device("cpu")] * 2
        assert s.state["gen"][1].device == torch.device("cpu")
        new = _answer(s.base, body, 11)
        eng_b = _engine(ckpt_b, cfg_b)
        want = eng_b.generate(_prep(body, cfg_b.preemph), z=_seed_z(eng_b.G, 11))[0]
        np.testing.assert_allclose(new, want, rtol=SELF_TOL, atol=SELF_TOL)
        assert np.abs(new - old).max() > 100 * SELF_TOL  # the control: A's answer
        eng_a = _engine(ckpt, cfg)
        np.testing.assert_allclose(
            old, eng_a.generate(_prep(body, cfg.preemph), z=_seed_z(eng_a.G, 11))[0],
            rtol=SELF_TOL, atol=SELF_TOL)
    finally:
        s.stop()


def test_healthz_warm_s_times_the_warm_up_generate_only(ckpts, monkeypatch):
    """/healthz's warm_s is the warm-up generate() alone, as root serve.py times it: the
    WindowBatcher's warm passes (slowed here) are not in it."""
    ckpt, opts, _ = ckpts["A"]
    generate, warm = SEGAN.generate, serving.WindowBatcher.warm
    spans = []

    def timed_generate(self, *a, **k):
        t0 = time.perf_counter()
        out = generate(self, *a, **k)
        spans.append(time.perf_counter() - t0)
        return out

    def slow_warm(self, window, max_rows=None):
        time.sleep(1.0)
        return warm(self, window, max_rows)

    monkeypatch.setattr(SEGAN, "generate", timed_generate)
    monkeypatch.setattr(serving.WindowBatcher, "warm", slow_warm)
    s = Server(ckpt, opts)
    try:
        warm_s = _get_json(s.base, "/healthz")["warm_s"]
        assert len(spans) == 1 and 0 < warm_s <= round(spans[0], 3) + 1e-3 < 1.0, (
            warm_s, spans)
    finally:
        s.stop()


def test_counters_never_go_back_across_reloads(ckpts, short_retire):
    """/healthz and /metrics count the retired generations' passes: folded at the swap,
    and the passes after it at retirement."""
    (ckpt, opts, _), (ckpt_b, _, _) = ckpts["A"], ckpts["B"]
    s = Server(ckpt, opts)
    try:
        samples = []

        def sample():
            m = _metrics(s.base)
            h = _get_json(s.base, "/healthz")
            samples.append((m, h))

        sample()
        for i, g in enumerate((ckpt_b, ckpt, ckpt_b)):
            _post(s.base, f"/enhance?seed={i}", _wav_bytes(n=3000, seed=i))
            _stream(s.host, _pcm(2500, seed=i).tobytes(), f"seed={i}&window=1024",
                    (1000,))
            sample()
            _reload(s.base, {"g_ckpt": str(g)})
            sample()
        _wait_retired(s.state)
        sample()
        for (m0, h0), (m1, h1) in zip(samples, samples[1:]):
            for k in COUNTERS:
                assert m1[k] >= m0[k], (k, m0[k], m1[k])
            for k in ("requests", "batches", "win_batches", "win_windows", "reloads"):
                assert h1[k] >= h0[k], (k, h0[k], h1[k])
        m, h = samples[-1]
        assert m["segan_reloads_total"] == h["reloads"] == 3
        assert m["segan_requests_total"] == h["requests"] == 6
        assert m["segan_device_passes_total"] == h["batches"] >= 3
        assert m["segan_stream_windows_total"] == h["win_windows"] == 3 * 3  # 3 a stream
        assert h["win_batches"] == m["segan_stream_window_passes_total"] >= 3
    finally:
        s.stop()


def test_reload_to_a_wsegan_cfg_file_switches_the_engine(ckpts, short_retire):
    (ckpt, opts, _), (ckpt_w, opts_w, cfg_w) = ckpts["A"], ckpts["W"]
    s = Server(ckpt, opts)
    try:
        assert _get_json(s.base, "/healthz")["model"] == "SEGAN"
        _reload(s.base, {"g_ckpt": str(ckpt_w), "cfg_file": str(opts_w)})
        assert _get_json(s.base, "/healthz")["model"] == "WSEGAN"
        assert s.state["cfg_file"] == str(opts_w)
        bodies = [_wav_bytes(n=n, seed=20 + n) for n in (2500, 1024, 4000)]
        got = [_answer(s.base, b, 30 + i) for i, b in enumerate(bodies)]
        ref = WSEGAN(cfg_w, device="cpu")
        ref.g_load_pretrained(str(ckpt_w))
        lengths = [3072, 2048, 4096]  # padded to a multiple of 1024, a full one more
        want = ref.generate_batch([_prep(b, cfg_w.preemph) for b in bodies],
                                  z=[_seed_z(ref.G, 30 + i, L) for i, L in enumerate(lengths)])
        for g, (w, _) in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=SELF_TOL, atol=SELF_TOL)
    finally:
        s.stop()


def test_reloaded_engine_equals_the_jax_engine(ckpts, short_retire):
    """The generation a reload builds, given the JAX engine's z, answers as the JAX
    engine (segan_pytorch_tpu/utils/engine.py) loaded from the same torch checkpoint."""
    import jax

    from segan_pytorch_tpu.utils.engine import build_enhancement_engine as jax_engine

    (ckpt, opts, _), (ckpt_b, opts_b, cfg_b) = ckpts["A"], ckpts["B"]
    s = Server(ckpt, opts)
    try:
        _reload(s.base, {"g_ckpt": str(ckpt_b)})
        _, engine, batcher, _ = s.state["gen"]
        _, jseg = jax_engine(str(opts_b), str(ckpt_b), seed=111)
        for i, n in enumerate((1024, 2500)):
            pwav = _prep(_wav_bytes(n=n, seed=40 + i), cfg_b.preemph)
            key = jax.random.PRNGKey(50 + i)
            want = np.asarray(jseg.generate(pwav, rng=key)[0])
            z = np.asarray(jseg.G.sample_z(key, (1, 1024, 1)))
            got = batcher.enhance(pwav, z=z)
            np.testing.assert_allclose(got, want, rtol=SELF_TOL, atol=SELF_TOL)
            np.testing.assert_allclose(engine.generate(pwav, z=z)[0], want,
                                       rtol=SELF_TOL, atol=SELF_TOL)
    finally:
        s.stop()


def test_warm_up_runs_before_the_swap_and_a_failed_build_closes_what_it_built(
        ckpts, monkeypatch):
    """The new engine's generate() and the WindowBatcher's warm-up run while the old
    generation still serves; a build that fails after its MicroBatcher started stops
    that batcher's thread, answers 500 and keeps the old generation."""
    (ckpt, opts, _), (ckpt_b, _, _) = ckpts["A"], ckpts["B"]
    s = Server(ckpt, opts)
    try:
        old = s.state["gen"]
        seen = []
        warm = serving.WindowBatcher.warm

        def recorded_warm(self, window, max_rows=None):
            seen.append((s.state["gen"] is old, self.segan is not old[1]))
            return warm(self, window, max_rows)

        monkeypatch.setattr(serving.WindowBatcher, "warm", recorded_warm)
        _reload(s.base, {"g_ckpt": str(ckpt_b)})
        assert seen == [(True, True)] and s.state["gen"] is not old
        built = []
        init = serving.MicroBatcher.__init__

        def recorded_init(self, *a, **k):
            init(self, *a, **k)
            built.append(self)

        def failing_warm(self, window, max_rows=None):
            raise RuntimeError("warm-up failed")

        monkeypatch.setattr(serving.MicroBatcher, "__init__", recorded_init)
        monkeypatch.setattr(serving.WindowBatcher, "warm", failing_warm)
        current = s.state["gen"]
        err = _error(s.base, "/admin/reload", json.dumps({"g_ckpt": str(ckpt)}).encode())
        assert err.code == 500 and "warm-up failed" in json.loads(err.read())["error"]
        assert s.state["gen"] is current and len(built) == 1
        assert not built[0]._worker.is_alive()
    finally:
        s.stop()


def test_one_reload_at_a_time(ckpts, short_retire, monkeypatch):
    (ckpt, opts, _), (ckpt_b, _, _) = ckpts["A"], ckpts["B"]
    s = Server(ckpt, opts)
    try:
        active, overlaps = [], []
        build = serve.build_generation

        def recorded(state, cfg_file, g_ckpt):
            active.append(1)
            overlaps.append(len(active))
            try:
                time.sleep(0.1)
                return build(state, cfg_file, g_ckpt)
            finally:
                active.pop()

        monkeypatch.setattr(serve, "build_generation", recorded)
        out = []
        ts = [threading.Thread(target=lambda g=g: out.append(
            _reload(s.base, {"g_ckpt": str(g)}))) for g in (ckpt_b, ckpt, ckpt_b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert overlaps == [1, 1, 1] and sorted(o["reloads"] for o in out) == [1, 2, 3]
    finally:
        s.stop()


def test_requests_in_flight_during_a_reload_get_one_engine_or_the_other(ckpts,
                                                                       short_retire):
    """Requests sent without pause while a reload swaps A for B: every answer is 200 and
    equals A's or B's, and every request sent after the reload's answer gets B's."""
    (ckpt, opts, cfg), (ckpt_b, _, cfg_b) = ckpts["A"], ckpts["B"]
    s = Server(ckpt, opts)
    try:
        body = _wav_bytes(n=1024, seed=8)
        refs = {}
        for name, (c, f) in (("A", (ckpt, cfg)), ("B", (ckpt_b, cfg_b))):
            e = _engine(c, f)
            refs[name] = [e.generate(_prep(body, f.preemph), z=_seed_z(e.G, k))[0]
                          for k in range(4)]
        got, stop = [], threading.Event()

        def client(k):
            while not stop.is_set():
                t0 = time.perf_counter()
                got.append((k, t0, _answer(s.base, body, k)))

        ts = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        time.sleep(0.3)
        _reload(s.base, {"g_ckpt": str(ckpt_b)})
        t_done = time.perf_counter()
        time.sleep(0.3)
        stop.set()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        kinds = []
        for k, t0, a in got:
            err = {n: np.abs(a - refs[n][k]).max() for n in refs}
            assert min(err.values()) <= SELF_TOL, err
            kinds.append(min(err, key=err.get))
            if t0 > t_done:
                assert kinds[-1] == "B"
        assert "A" in kinds and "B" in kinds
        assert np.abs(refs["A"][0] - refs["B"][0]).max() > 100 * SELF_TOL  # a control
    finally:
        s.stop()


# -- retirement and close() -----------------------------------------------------------
def test_retired_generation_is_closed_and_collected(ckpts, short_retire):
    (ckpt, opts, _), (ckpt_b, _, _) = ckpts["A"], ckpts["B"]
    s = Server(ckpt, opts)
    try:
        _post(s.base, "/enhance?seed=1", _wav_bytes(n=2048))
        _, engine, batcher, wb = s.state["gen"]
        refs = [weakref.ref(v) for v in (engine, batcher, wb)]
        workers = [batcher._worker, wb._worker]
        del engine, batcher, wb
        _reload(s.base, {"g_ckpt": str(ckpt_b)})
        _wait_retired(s.state)
        assert not any(w.is_alive() for w in workers)
        gc.collect()
        assert [r() for r in refs] == [None, None, None]
        assert s.state["gen"][2]._worker.is_alive()  # the new generation serves
        assert _post(s.base, "/enhance?seed=1", _wav_bytes(n=2048))[0] == 200
    finally:
        s.stop()


def test_close_stops_every_batcher_thread(ckpts):
    """With the default retire delay, close() retires the replaced generations at once:
    no batcher thread of any generation outlives it."""
    (ckpt, opts, _), (ckpt_b, _, _) = ckpts["A"], ckpts["B"]
    assert serve.RETIRE_SECONDS == 150
    s = Server(ckpt, opts)
    workers = [s.state["gen"][2]._worker, s.state["gen"][3]._worker]
    try:
        for g in (ckpt_b, ckpt):
            _reload(s.base, {"g_ckpt": str(g)})
            workers += [s.state["gen"][2]._worker, s.state["gen"][3]._worker]
        assert all(w.is_alive() for w in workers)
        assert sum(t.is_alive() for t in s.state["retiring"]) == 2
    finally:
        t0 = time.perf_counter()
        s.stop()
    assert time.perf_counter() - t0 < 30
    assert not any(w.is_alive() for w in workers)
    assert not any(t.is_alive() for t in s.state["retiring"])
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(s.base + "/healthz", timeout=5)


@pytest.mark.parametrize("flag", ["--port", "--ws_port"])
def test_a_listener_that_cannot_bind_stops_the_batchers(ckpts, flag):
    """build_server fails on a port in use, and leaves no batcher thread behind."""
    import socket

    ckpt, opts, _ = ckpts["A"]

    def batcher_threads():
        return {t for t in threading.enumerate()
                if t.name in ("microbatcher", "windowbatcher")}

    before = batcher_threads()
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        port = str(busy.getsockname()[1])
        argv = ["--port", port] if flag == "--port" else ["--port", "0", "--ws_port", port]
        with pytest.raises(OSError):
            serve.build_server(serve.parse_args(
                ["--g_pretrained_ckpt", str(ckpt), "--cfg_file", str(opts),
                 "--warm_seconds", "0.1", "--device", "cpu", *argv]))
    assert batcher_threads() <= before


def test_reload_probe_cpu_run(ckpts, tmp_path, capsys):
    """tools/reload_leak_probe.py with --device cpu: every retired generation is
    collected and the kernel's cache keeps nothing of it."""
    ckpt, opts, _ = ckpts["A"]
    out = tmp_path / "probe.json"
    rc = reload_leak_probe.main(["--g_ckpt", str(ckpt), "--cfg_file", str(opts),
                                 "--iters", "3", "--warm_seconds", "0.1", "--device", "cpu",
                                 "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0, report
    assert report["verdict"] == {"objects_collected": True, "memory_released": True,
                                 "padded_released": True}
    assert [r["alive"] for r in report["rows"]] == [[], [], []]
    assert report["baseline"]["memory_allocated"] is None  # not measured on the CPU
    assert all(r["rss_kb"] > 0 for r in report["rows"])
    assert "generation 2" in capsys.readouterr().out


# -- TLS and mutual TLS -----------------------------------------------------------------
def _mint(root, name, cn):
    cert, key = root / f"{name}.pem", root / f"{name}.key"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
                    str(key), "-out", str(cert), "-days", "1", "-subj", f"/CN={cn}"],
                   check=True, capture_output=True)
    return cert, key


def _client_ctx(cert=None):
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    if cert is not None:
        ctx.load_cert_chain(*map(str, cert))
    return ctx


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    if shutil.which("openssl") is None:
        pytest.skip("the openssl command line is needed to mint test certificates")
    root = tmp_path_factory.mktemp("certs")
    return {"server": _mint(root, "server", "localhost"),
            "client": _mint(root, "client", "segan-client")}


@pytest.mark.parametrize("flags, message", [
    (["--tls_key", "k.pem"], "--tls_cert and --tls_key must be given together"),
    (["--tls_cert", "c.pem"], "--tls_cert and --tls_key must be given together"),
    (["--tls_client_ca", "ca.pem"], "--tls_client_ca requires --tls_cert/--tls_key")])
def test_tls_flags_are_checked_by_the_parser(flags, message, capsys):
    with pytest.raises(SystemExit) as ei:
        serve.parse_args(["--g_pretrained_ckpt", "g", "--cfg_file", "c", *flags])
    assert ei.value.code == 2 and message in capsys.readouterr().err


def test_https_healthz_and_enhance(ckpts, certs):
    (ckpt, opts, cfg), (cert, key) = ckpts["A"], certs["server"]
    s = Server(ckpt, opts, "--tls_cert", str(cert), "--tls_key", str(key))
    base = s.base.replace("http://", "https://")
    try:
        ctx = _client_ctx()
        with urllib.request.urlopen(base + "/healthz", timeout=10, context=ctx) as r:
            assert json.loads(r.read())["status"] == "ok"
        body = _wav_bytes(n=2048, seed=2)
        req = urllib.request.Request(base + "/enhance?seed=4", data=body)
        with urllib.request.urlopen(req, timeout=60, context=ctx) as r:
            enh = wavfile.read(io.BytesIO(r.read()))[1]
        eng = _engine(ckpt, cfg)
        np.testing.assert_allclose(
            enh, eng.generate(_prep(body, cfg.preemph), z=_seed_z(eng.G, 4))[0],
            rtol=SELF_TOL, atol=SELF_TOL)
        # plain HTTP on the TLS port gets no answer
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(s.base + "/healthz", timeout=10)
    finally:
        s.stop()


def test_a_stalled_handshake_does_not_block_the_accept_loop(ckpts, certs):
    """A client that connects and never sends its TLS hello holds its own handler
    thread only: another client is answered meanwhile."""
    import socket

    (ckpt, opts, _), (cert, key) = ckpts["A"], certs["server"]
    s = Server(ckpt, opts, "--tls_cert", str(cert), "--tls_key", str(key))
    try:
        with socket.create_connection(("127.0.0.1", s.srv.server_address[1]), timeout=10):
            with urllib.request.urlopen(s.base.replace("http://", "https://") + "/healthz",
                                        timeout=10, context=_client_ctx()) as r:
                assert r.status == 200
    finally:
        s.stop()


def test_mutual_tls_refuses_a_client_without_a_certificate(ckpts, certs):
    (ckpt, opts, _), (cert, key) = ckpts["A"], certs["server"]
    cli = certs["client"]  # self-signed: its own CA, the one identity the server trusts
    s = Server(ckpt, opts, "--tls_cert", str(cert), "--tls_key", str(key),
               "--tls_client_ca", str(cli[0]))
    base = s.base.replace("http://", "https://")
    try:
        with pytest.raises((ssl.SSLError, urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(base + "/healthz", timeout=10, context=_client_ctx())
        with pytest.raises((ssl.SSLError, urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(base + "/healthz", timeout=10,
                                   context=_client_ctx(certs["server"]))  # not the CA's
        ctx = _client_ctx(cli)
        with urllib.request.urlopen(base + "/healthz", timeout=10, context=ctx) as r:
            assert r.status == 200
        req = urllib.request.Request(base + "/enhance?seed=1", data=_wav_bytes(n=2048))
        with urllib.request.urlopen(req, timeout=60, context=ctx) as r:
            assert wavfile.read(io.BytesIO(r.read()))[1].shape == (2048,)
    finally:
        s.stop()
