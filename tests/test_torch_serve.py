"""The port's server (``python -m segan_pytorch_tpu_torch.serve``) over HTTP with
``--device cpu`` at toy width, as ``tests/test_serve.py`` drives the repo's ``serve.py``:
/healthz, /enhance (formats, seeds, overlap, the 400 / 404 / 413 / 501 answers, the body
drained before keep-alive reuse), /enhance_stream (chunked and sized, the session guard,
coalescing), /metrics, bearer auth, the SIGTERM drain and a WSEGAN checkpoint. The copied
helpers are pinned to ``serve.py``'s. Reload, TLS and the WebSocket listener have files of
their own: ``test_torch_serve_reload.py`` and ``test_torch_serve_ws.py``.

The servers run in this process (``build_server`` and ``serve_forever`` on a thread),
apart from one subprocess for the command line and the SIGTERM drain.
"""
import http.client
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from segan_pytorch_tpu_torch import serve
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
from segan_pytorch_tpu_torch.ops.signal import normalize_wave_minmax, pre_emphasize_np
from segan_pytorch_tpu_torch.parallel.inference import chunk_grid, overlap_add
from segan_pytorch_tpu_torch.utils.checkpoint import save_generator
from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts

ROOT = Path(__file__).resolve().parents[1]
TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
           z_dim=32, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16)
# a served answer against the engine's own generate() with the same z: one request per
# pass runs the same rows (equal up to the CPU convs' order for other batch shapes)
SELF_TOL = 1e-5
PCM_TOL = 1  # PCM16 outputs: one least significant bit either side of a rounding


def _root_serve():
    spec = importlib.util.spec_from_file_location("root_serve", ROOT / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checkpoint(root: Path, **kw):
    """A toy G with random weights (slopes U(0, 0.3)) as a .ckpt with its train.opts. Its
    output layer is quiet (weights x 0.05, bias 0), so that the de-emphasized output
    stays within PCM16's range instead of clipping."""
    cfg = SEGANConfig(**TOY, **kw, save_path=str(root))
    gen = torch.Generator().manual_seed(0)
    G = build_generator(cfg, gen)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("act.weight"):
                p.uniform_(0.0, 0.3, generator=gen)
        G.dec_blocks[-1].deconv.bias.zero_()
        if cfg.gnorm_type != "snorm":
            G.dec_blocks[-1].deconv.weight.mul_(0.05)
        else:
            # u and v near the top singular pairs: a few power iterations in train mode
            G.train()
            for _ in range(3):
                G(torch.randn(1, 1024, 1, generator=gen), torch.randn(1, 16, 32, generator=gen))
            G.eval()
    ckpt = root / "g.ckpt"
    save_generator(G, str(ckpt))
    return ckpt, dump_train_opts(cfg, str(root)), cfg


def _opts(ckpt, cfg_file, *extra):
    return serve.parse_args(
        ["--g_pretrained_ckpt", str(ckpt), "--cfg_file", str(cfg_file), "--port", "0",
         "--warm_seconds", "0.1", "--device", "cpu", *extra])


class Server:
    """build_server + serve_forever on a thread; stop() shuts it down."""

    def __init__(self, ckpt, cfg_file, *extra):
        self.srv, self.state = serve.build_server(_opts(ckpt, cfg_file, *extra))
        self.base = "http://127.0.0.1:%d" % self.srv.server_address[1]
        self.host = self.base.split("//")[1]
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        self.srv.shutdown()
        serve.close(self.srv, self.state)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _checkpoint(tmp_path_factory.mktemp("serve"), no_bias=True)


@pytest.fixture(scope="module")
def server(toy):
    ckpt, cfg_file, _ = toy
    s = Server(ckpt, cfg_file)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def engine(toy):
    """The server's engine, loaded as the server loads it."""
    ckpt, cfg_file, cfg = toy
    seg = SEGAN(cfg, device="cpu")
    seg.g_load_pretrained(str(ckpt))
    return seg


def _signal(n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return 0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.randn(n)


def _wav_bytes(n=3000, seed=0, dtype=np.int16, rate=16000):
    x = _signal(n, seed)
    data = (np.clip(x, -1, 1) * 32767).astype(np.int16) if dtype == np.int16 else \
        x.astype(dtype)
    buf = io.BytesIO()
    wavfile.write(buf, rate, data)
    return buf.getvalue()


def _post(base, path, body, headers=None, timeout=60):
    req = urllib.request.Request(base + path, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _get_json(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return json.loads(r.read())


def _error(base, path, body, headers=None, method=None):
    req = urllib.request.Request(base + path, data=body, headers=headers or {},
                                 method=method)
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    return ei.value


def _metrics(base):
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        text = r.read().decode()
    return {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
            if ln and not ln.startswith("#")}


def _prep(body, preemph):
    """The server's input path: a WAV's samples to the pre-emphasized waveform."""
    _, wav = wavfile.read(io.BytesIO(body))
    return pre_emphasize_np(normalize_wave_minmax(serve._as_int16(wav)), preemph)


def _seed_z(G, seed, length=1024):
    return G.sample_z((1, length, 1), torch.Generator().manual_seed(seed))


# -- the copied helpers, pinned to serve.py's -----------------------------------------
def test_parse_params_equals_serve_py():
    root = _root_serve()
    for q in ("", "seed=5", "seed=5&overlap=0.25&format=pcm16", "a%20b=c%26d&x=",
              "novalue&k=v=w", "window=2048&&seed=-3", "%E2%9C%93=1"):
        assert serve._parse_params(q) == root._parse_params(q), q
    assert serve.MAX_BODY_BYTES == root.MAX_BODY_BYTES


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32", "float64",
                                   "stereo"])
def test_as_int16_equals_serve_py(dtype):
    root = _root_serve()
    rng = np.random.RandomState(1)
    data = {"int16": lambda: rng.randint(-32768, 32767, 999).astype(np.int16),
            "int32": lambda: rng.randint(-2**31, 2**31 - 1, 999).astype(np.int32),
            "uint8": lambda: rng.randint(0, 255, 999).astype(np.uint8),
            "float32": lambda: rng.uniform(-1.3, 1.3, 999).astype(np.float32),
            "float64": lambda: rng.uniform(-1.3, 1.3, 999),
            "stereo": lambda: rng.randint(-32768, 32767, (999, 2)).astype(np.int16)}[dtype]()
    got, want = serve._as_int16(data), root._as_int16(data)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        serve._as_int16(np.zeros(4, np.int64))


def test_inflight_counter_equals_serve_py():
    root = _root_serve()
    for cls in (serve.InflightCounter, root.InflightCounter):
        c = cls()
        with c:
            with c:
                assert c.count() == 2
            assert c.count() == 1
        assert c.count() == 0
        ts = [threading.Thread(target=lambda: [c.__enter__() for _ in range(500)])
              for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert c.count() == 4000


# -- the command line ------------------------------------------------------------------
def test_device_defaults_to_cuda_and_raises_without_a_card(toy, monkeypatch):
    ckpt, cfg_file, _ = toy
    opts = serve.build_parser().parse_args(["--g_pretrained_ckpt", str(ckpt),
                                            "--cfg_file", str(cfg_file)])
    assert opts.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.build_server(opts)


# -- /healthz, /enhance ----------------------------------------------------------------
class TestServe:
    def test_healthz(self, server):
        info = _get_json(server.base, "/healthz")
        assert info["status"] == "ok" and info["model"] == "SEGAN"
        assert info["slice_size"] == 1024 and info["auth"] is False
        assert info["stream_coalesce"] is True and info["reloads"] == 0

    def test_enhance_roundtrip_determinism_and_seed(self, server, engine):
        """Same seed, same answer; the answer is generate() with the seed's torch draw."""
        body = _wav_bytes()
        outs = []
        for _ in range(2):
            status, headers, data = _post(server.base, "/enhance?seed=5", body)
            assert status == 200 and float(headers["X-Enhance-Seconds"]) > 0
            rate, enh = wavfile.read(io.BytesIO(data))
            assert rate == 16000 and enh.shape == (3000,) and enh.dtype == np.float32
            outs.append(enh)
        np.testing.assert_array_equal(outs[0], outs[1])
        want = engine.generate(_prep(body, 0.95), z=_seed_z(engine.G, 5))[0]
        np.testing.assert_allclose(outs[0], want, rtol=SELF_TOL, atol=SELF_TOL)
        _, _, other = _post(server.base, "/enhance?seed=6", body)
        assert other != _post(server.base, "/enhance?seed=5", body)[2]

    @pytest.mark.parametrize("dtype", [np.int16, np.float32])
    def test_enhance_pcm16_format(self, server, dtype):
        _, _, data = _post(server.base, "/enhance?format=pcm16&seed=1",
                           _wav_bytes(n=2048, dtype=dtype))
        _, enh = wavfile.read(io.BytesIO(data))
        assert enh.dtype == np.int16 and enh.shape == (2048,)

    def test_bad_input_is_400_and_server_survives(self, server):
        for path, body in (("/enhance", b"not a wav"),
                           ("/enhance", _wav_bytes(n=1000, rate=8000)),
                           ("/enhance?seed=abc", _wav_bytes(n=1000)),
                           ("/enhance", _wav_bytes(n=1000, dtype=np.int64))):
            assert _error(server.base, path, body).code == 400, path
        assert _get_json(server.base, "/healthz")["status"] == "ok"

    def test_unknown_paths_404_and_reload_501(self, server):
        """Unknown paths are 404, GET /admin/reload too; the 501 that a POST of it got
        before the reload was ported is gone (test_torch_serve_reload.py holds it)."""
        assert _error(server.base, "/nothing", b"x").code == 404
        for path in ("/nothing", "/admin/reload"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(server.base + path, timeout=10)
            assert ei.value.code == 404
        err = _error(server.base, "/admin/reload", json.dumps({"cfg_file": "x"}).encode())
        assert err.code == 400 and "g_ckpt" in json.loads(err.read())["error"]

    def test_too_large_is_413_and_chunked_is_501(self, server):
        conn = http.client.HTTPConnection(server.host, timeout=30)
        try:
            conn.putrequest("POST", "/enhance")
            conn.putheader("Content-Length", str(serve.MAX_BODY_BYTES + 1))
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 413
            resp.read()
        finally:
            conn.close()
        conn = http.client.HTTPConnection(server.host, timeout=30)
        try:
            conn.putrequest("POST", "/enhance")
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            conn.send(b"4\r\nabcd\r\n0\r\n\r\n")
            resp = conn.getresponse()
            assert resp.status == 501
            resp.read()
        finally:
            conn.close()

    def test_body_drained_before_keep_alive_reuse(self, server):
        """A 400 and a 200 on one connection: the first body is read before the next
        request line is parsed."""
        conn = http.client.HTTPConnection(server.host, timeout=60)
        try:
            conn.request("POST", "/enhance?overlap=0.9", body=_wav_bytes(n=2000))
            resp = conn.getresponse()
            assert resp.status == 400
            resp.read()
            conn.request("POST", "/enhance?seed=2", body=_wav_bytes(n=2000))
            resp = conn.getresponse()
            assert resp.status == 200
            assert wavfile.read(io.BytesIO(resp.read()))[1].shape == (2000,)
        finally:
            conn.close()

    def test_enhance_with_overlap(self, server, engine):
        body = _wav_bytes(n=2500)
        _, _, data = _post(server.base, "/enhance?seed=2&overlap=0.25", body)
        enh = wavfile.read(io.BytesIO(data))[1]
        want = engine.generate(_prep(body, 0.95), z=_seed_z(engine.G, 2), overlap=0.25)[0]
        np.testing.assert_allclose(enh, want, rtol=SELF_TOL, atol=SELF_TOL)
        assert _error(server.base, "/enhance?overlap=0.9", body).code == 400

    def test_concurrent_requests_coalesce(self, server, engine):
        """Twelve concurrent posts with their own seeds: each answer is its own, and
        /metrics shows fewer G passes than requests."""
        before = _metrics(server.base)
        bodies = [_wav_bytes(n=1000 + 500 * (i % 4), seed=9 + i) for i in range(12)]
        outs = [None] * 12

        def hit(i):
            outs[i] = _post(server.base, f"/enhance?seed={20 + i}", bodies[i])[2]

        ts = [threading.Thread(target=hit, args=(i,)) for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        after = _metrics(server.base)
        assert after["segan_requests_total"] - before["segan_requests_total"] == 12
        passes = after["segan_device_passes_total"] - before["segan_device_passes_total"]
        assert 1 <= passes < 12
        for i, out in enumerate(outs):
            want = engine.generate(_prep(bodies[i], 0.95), z=_seed_z(engine.G, 20 + i))[0]
            np.testing.assert_allclose(wavfile.read(io.BytesIO(out))[1], want,
                                       rtol=SELF_TOL, atol=SELF_TOL)

    def test_metrics(self, server):
        m = _metrics(server.base)
        assert set(m) == {"segan_requests_total", "segan_device_passes_total",
                          "segan_stream_window_passes_total", "segan_stream_windows_total",
                          "segan_inflight_requests", "segan_reloads_total",
                          "segan_enhance_seconds_sum", "segan_draining"}
        assert m["segan_reloads_total"] == 0 and m["segan_draining"] == 0
        n = m["segan_requests_total"]
        _post(server.base, "/enhance?seed=3", _wav_bytes(n=1500))
        m2 = _metrics(server.base)
        assert m2["segan_requests_total"] == n + 1
        assert m2["segan_enhance_seconds_sum"] > m["segan_enhance_seconds_sum"]
        assert m2["segan_device_passes_total"] >= m["segan_device_passes_total"] + 1


# -- /enhance_stream -------------------------------------------------------------------
def _pcm(n=2500, seed=5):
    return (np.clip(_signal(n, seed), -1, 1) * 32767).astype("<i2")


def _stream(host, pcm_bytes, query, chunk_sizes):
    """A chunked POST of raw PCM16; returns the streamed PCM16."""
    conn = http.client.HTTPConnection(host, timeout=120)
    try:
        conn.putrequest("POST", "/enhance_stream?" + query)
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        pos = 0
        for sz in chunk_sizes:
            piece = pcm_bytes[pos: pos + sz]
            pos += len(piece)
            if piece:
                conn.send(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
        rest = pcm_bytes[pos:]
        if rest:
            conn.send(f"{len(rest):x}\r\n".encode() + rest + b"\r\n")
        conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()[:500]
        assert int(resp.headers["X-Stream-Latency-Samples"]) > 0
        return np.frombuffer(resp.read(), dtype="<i2")
    finally:
        conn.close()


def _offline_pcm(engine, pcm, window, overlap, seed):
    """The offline chunk_grid + overlap_add path with the stream's z, as PCM16."""
    pe = pre_emphasize_np(normalize_wave_minmax(pcm), engine.preemph)
    grid, hop, n = chunk_grid(pe, window, overlap)
    out = engine.infer_G(grid, _seed_z(engine.G, seed, window).expand(n, -1, -1)).numpy()
    from segan_pytorch_tpu_torch.ops.signal import de_emphasize_np

    y = de_emphasize_np(overlap_add(out, hop, len(pcm)), engine.preemph)
    return np.clip(y * 32767.0, -32768, 32767).astype("<i2")


class TestServeStreaming:
    @pytest.mark.parametrize("window", [1024, 2048])
    def test_stream_equals_offline_whatever_the_pieces(self, server, engine, window):
        pcm = _pcm()
        query = f"seed=3&overlap=0.25&window={window}"
        out = _stream(server.host, pcm.tobytes(), query, (400, 1601, 999, 10**9))
        assert out.shape == (2500,)
        np.testing.assert_array_equal(
            out, _stream(server.host, pcm.tobytes(), query, (5000,)))
        want = _offline_pcm(engine, pcm, window, 0.25, 3)
        assert int(np.abs(out.astype(int) - want.astype(int)).max()) <= PCM_TOL

    def test_stream_with_content_length(self, server):
        pcm = _pcm(1800, seed=8).tobytes()
        status, headers, data = _post(server.base, "/enhance_stream?seed=4&window=1024",
                                      pcm)
        assert status == 200 and headers["Transfer-Encoding"] == "chunked"
        np.testing.assert_array_equal(
            np.frombuffer(data, "<i2"),
            _stream(server.host, pcm, "seed=4&window=1024", (777,)))

    def test_stream_bad_window_or_param_is_400(self, server):
        for q in ("window=1000", "overlap=0.6", "seed=x"):
            assert _error(server.base, "/enhance_stream?" + q, b"\x00\x00" * 100).code == 400

    def test_concurrent_streams_coalesce(self, server):
        """Four streams at once: each equals its solo run, and the window passes are
        fewer than the windows."""
        before = _metrics(server.base)
        pcms = [_pcm(3000, seed=30 + i).tobytes() for i in range(4)]
        outs = [None] * 4

        def run(i):
            outs[i] = _stream(server.host, pcms[i], f"seed={i}&window=1024",
                              (1000, 1000, 10**9))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        after = _metrics(server.base)
        windows = after["segan_stream_windows_total"] - before["segan_stream_windows_total"]
        passes = (after["segan_stream_window_passes_total"]
                  - before["segan_stream_window_passes_total"])
        assert windows == 4 * 4 and 1 <= passes <= windows
        for i, out in enumerate(outs):
            solo = _stream(server.host, pcms[i], f"seed={i}&window=1024", (10**9,))
            assert int(np.abs(out.astype(int) - solo.astype(int)).max()) <= PCM_TOL

    def test_stream_session_guard_truncates(self, toy):
        """--max_stream_seconds: a stream outliving the cap is finalized from the audio
        fed so far; a silent client is finalized at the read timeout."""
        ckpt, cfg_file, _ = toy
        s = Server(ckpt, cfg_file, "--max_stream_seconds", "1.0", "--no_stream_coalesce")
        try:
            assert _get_json(s.base, "/healthz")["stream_coalesce"] is False
            n = 4096
            pcm = _pcm(n, seed=1).tobytes()
            conn = http.client.HTTPConnection(s.host, timeout=120)
            try:
                conn.putrequest("POST", "/enhance_stream?seed=1&window=1024&overlap=0")
                conn.putheader("Transfer-Encoding", "chunked")
                conn.endheaders()
                step = len(pcm) // 20
                for i in range(20):
                    p = pcm[i * step:(i + 1) * step]
                    conn.send(f"{len(p):x}\r\n".encode() + p + b"\r\n")
                    time.sleep(0.1)
                conn.send(b"0\r\n\r\n")
                resp = conn.getresponse()
                assert resp.status == 200
                out = np.frombuffer(resp.read(), dtype="<i2")
                assert 0 < out.size < n, out.size
            finally:
                conn.close()
            conn = http.client.HTTPConnection(s.host, timeout=120)
            try:
                conn.putrequest("POST", "/enhance_stream?seed=1&window=1024&overlap=0")
                conn.putheader("Transfer-Encoding", "chunked")
                conn.endheaders()
                half = len(pcm) // 2
                conn.send(f"{half:x}\r\n".encode() + pcm[:half] + b"\r\n")
                resp = conn.getresponse()  # no last chunk: the read times out
                assert resp.status == 200
                assert np.frombuffer(resp.read(), dtype="<i2").size == n // 2
            finally:
                conn.close()
        finally:
            s.stop()


# -- auth, WSEGAN, the command line and its drain --------------------------------------
def test_auth_token(toy):
    ckpt, cfg_file, _ = toy
    s = Server(ckpt, cfg_file, "--auth_token", "sekrit-42")
    try:
        assert _get_json(s.base, "/healthz")["auth"] is True  # open for probes
        assert "segan_requests_total" in _metrics(s.base)
        body = _wav_bytes(n=2048)
        for hdrs in ({}, {"Authorization": "Bearer wrong"},
                     {"Authorization": "Basic sekrit-42"},
                     {"Authorization": "Bearer f\xf6o"}):
            err = _error(s.base, "/enhance", body, hdrs)
            assert err.code == 401 and err.headers["WWW-Authenticate"] == "Bearer"
        assert _error(s.base, "/enhance_stream?window=1024", b"\x00\x00" * 512).code == 401
        assert _error(s.base, "/admin/reload", b"{}").code == 401
        status, _, data = _post(s.base, "/enhance?seed=1", body,
                                {"Authorization": "Bearer sekrit-42"})
        assert status == 200 and len(data) > 0
    finally:
        s.stop()


def test_unauthorized_body_is_read_before_the_401(toy):
    """A 401 reads a sized body before it closes: a close with unread data resets the
    connection, and the client then loses the answer (about 1 in 8 of these posts did
    while the body was left unread)."""
    ckpt, cfg_file, _ = toy
    s = Server(ckpt, cfg_file, "--auth_token", "sekrit-42")
    try:
        for _ in range(20):
            err = _error(s.base, "/admin/reload", b"x" * (1 << 20))
            assert err.code == 401 and json.loads(err.read()) == {"error": "unauthorized"}
    finally:
        s.stop()


def test_auth_token_from_the_environment(toy, monkeypatch):
    ckpt, cfg_file, _ = toy
    monkeypatch.setenv("SEGAN_SERVE_TOKEN", "env-tok")
    s = Server(ckpt, cfg_file)
    try:
        assert _error(s.base, "/enhance", _wav_bytes(n=1024)).code == 401
        assert _post(s.base, "/enhance", _wav_bytes(n=1024),
                     {"Authorization": "Bearer env-tok"})[0] == 200
    finally:
        s.stop()


def test_wsegan_checkpoint_served_with_engine_semantics(tmp_path):
    """A WSEGAN checkpoint: /healthz names the engine, and /enhance equals its
    generate() (one pass over the utterance padded to a multiple of 1024) with the
    seed's draw."""
    ckpt, cfg_file, cfg = _checkpoint(tmp_path, gnorm_type="snorm", wsegan=True)
    s = Server(ckpt, cfg_file)
    try:
        assert _get_json(s.base, "/healthz")["model"] == "WSEGAN"
        n = 2500
        body = _wav_bytes(n=n, seed=6)
        _, _, data = _post(s.base, "/enhance?seed=17", body)
        served = wavfile.read(io.BytesIO(data))[1]
    finally:
        s.stop()
    ref = WSEGAN(cfg, device="cpu")
    ref.g_load_pretrained(str(ckpt))
    direct = ref.generate(_prep(body, cfg.preemph), z=_seed_z(ref.G, 17, 3072))[0]
    assert served.shape == (n,)
    np.testing.assert_array_equal(served, direct)


def test_command_line_serves_and_drains_on_sigterm(toy):
    """python -m segan_pytorch_tpu_torch.serve --device cpu: a request in flight when
    SIGTERM comes is answered, and the process exits 0 within --drain_seconds."""
    ckpt, cfg_file, _ = toy
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "segan_pytorch_tpu_torch.serve", "--g_pretrained_ckpt",
         str(ckpt), "--cfg_file", str(cfg_file), "--port", str(port), "--warm_seconds",
         "0.1", "--drain_seconds", "10", "--device", "cpu"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 90
        while True:
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            try:
                if _get_json(base, "/healthz")["status"] == "ok":
                    break
            except OSError:
                assert time.time() < deadline, "the server never answered /healthz"
                time.sleep(0.2)
        results = {}

        def hit():
            results["status"], _, data = _post(base, "/enhance?seed=7",
                                               _wav_bytes(n=20000), timeout=60)
            results["n"] = wavfile.read(io.BytesIO(data))[1].shape[0]

        t = threading.Thread(target=hit)
        t.start()
        time.sleep(0.05)  # the request reaches the server
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=60)
        assert results == {"status": 200, "n": 20000}, results
        assert proc.wait(timeout=30) == 0
        log = proc.stdout.read()
        assert "listening on" in log and "shutdown complete" in log, log[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
