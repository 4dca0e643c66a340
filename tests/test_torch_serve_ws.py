"""The port's WebSocket ``/enhance_stream`` listener (``--ws_port``) with ``--device cpu``
at toy width, as ``tests/test_serve.py``'s ``TestServeWebSocket`` drives the repo's
``serve.py``: PCM byte-identical to the chunked-HTTP stream for one seed across idle gaps
longer than the ping interval, determinism per seed, close code 1008 for a bad query, an
unknown path or a bad token, ``tools/ws_client.py`` against the port's server, the
session guards, a sender that does not hold the SIGTERM drain, wss with mutual TLS, and
the server without the ``websockets`` package. Also the parser pinned to ``serve.py``'s,
and the lazy bf16 copy of G built once when several threads ask for it.

The servers run in this process, apart from one subprocess for the drain and one for
the client tool.
"""
import argparse
import json
import os
import signal
import socket
import ssl
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from segan_pytorch_tpu_torch import serve
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_serve import (ROOT, TOY, Server, _checkpoint, _get_json, _pcm, _root_serve,
                              _stream)
from test_torch_serve_reload import _client_ctx, _mint

QUERY = "seed=3&overlap=0.25&window=1024"


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _checkpoint(tmp_path_factory.mktemp("ws"), no_bias=True)


class WsServer(Server):
    """A Server with the WebSocket listener on a free port."""

    def __init__(self, ckpt, cfg_file, *extra):
        self.ws_port = _free_port()
        super().__init__(ckpt, cfg_file, "--ws_port", str(self.ws_port), *extra)
        self.ws_url = f"ws://127.0.0.1:{self.ws_port}/enhance_stream"


@pytest.fixture(scope="module")
def ws_server(toy):
    # a 0.3 s ping interval, so that an idle gap of 0.4 s spans pings
    ckpt, cfg_file, _ = toy
    s = WsServer(ckpt, cfg_file, "--ws_ping_interval", "0.3")
    yield s
    s.stop()


def _ws_stream(url, pcm_bytes, query, pieces, gap=0.0, token=None, ssl_ctx=None):
    """Feed the PCM in binary frames of the given sizes (the rest in one), `gap` seconds
    apart, send "end" and collect the PCM and the "done" frame. Frames are received on
    a thread of their own, as tools/ws_client.py does, so that a server that finalises
    early (a cap, a drain) is read to its "done"."""
    from websockets.exceptions import ConnectionClosed
    from websockets.sync.client import connect

    headers = {"Authorization": f"Bearer {token}"} if token else None
    out, done = bytearray(), {}

    with connect(f"{url}?{query}", additional_headers=headers, open_timeout=60,
                 ssl=ssl_ctx) as ws:
        def receive():
            while True:
                msg = ws.recv(timeout=120)
                if isinstance(msg, str):
                    return done.update(json.loads(msg))
                out.extend(msg)

        rx = threading.Thread(target=receive)
        rx.start()
        pos = 0
        try:
            for size in pieces:
                piece = pcm_bytes[pos: pos + size]
                pos += len(piece)
                if piece:
                    ws.send(piece)
                time.sleep(gap)
            if pos < len(pcm_bytes):
                ws.send(pcm_bytes[pos:])
            ws.send("end")
        except ConnectionClosed:
            pass  # the server finalised first: its "done" is on its way
        rx.join(timeout=120)
        assert not rx.is_alive() and done, "no 'done' frame"
    return np.frombuffer(bytes(out), dtype="<i2"), done


def _closed_with(url, **kw):
    """The close code of a session that the server ends before any audio."""
    from websockets.exceptions import ConnectionClosedError
    from websockets.sync.client import connect

    with pytest.raises(ConnectionClosedError) as ei:
        with connect(url, open_timeout=60, **kw) as ws:
            ws.recv(timeout=30)
    return ei.value.rcvd.code


# -- the protocol ------------------------------------------------------------------------
def test_ws_equals_http_stream_across_idle_gaps(ws_server):
    """The same seed gives the same PCM, byte for byte, over the WebSocket as over
    chunked HTTP, with the client silent for 0.4 s between pieces (pings every 0.3 s)."""
    n = 2500
    pcm = _pcm(n).tobytes()
    http_out = _stream(ws_server.host, pcm, QUERY, (10**9,))
    ws_out, done = _ws_stream(ws_server.ws_url, pcm, QUERY, (800, 1602, 998), gap=0.4)
    assert done == {"event": "done", "samples_out": n, "truncated": False}
    assert ws_out.shape == (n,)
    np.testing.assert_array_equal(ws_out, http_out)
    assert _get_json(ws_server.base, "/healthz")["ws_port"] == ws_server.ws_port


def test_ws_deterministic_per_seed(ws_server):
    pcm = _pcm(2048, seed=7).tobytes()
    a, _ = _ws_stream(ws_server.ws_url, pcm, "seed=11&window=1024", (4096,))
    b, _ = _ws_stream(ws_server.ws_url, pcm, "seed=11&window=1024", (100, 3000, 996))
    c, _ = _ws_stream(ws_server.ws_url, pcm, "seed=12&window=1024", (4096,))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).max() > 1


@pytest.mark.parametrize("tail", ["?window=1000", "?overlap=0.6", "?seed=x", "?window=x",
                                  ""])
def test_ws_bad_query_or_unknown_path_closes_1008(ws_server, tail):
    url = ws_server.ws_url + tail if tail else ws_server.ws_url.replace(
        "/enhance_stream", "/other")
    assert _closed_with(url) == 1008


def test_ws_counts_a_request_and_coalesces_windows(ws_server):
    before = _get_json(ws_server.base, "/healthz")
    _ws_stream(ws_server.ws_url, _pcm(2500, seed=1).tobytes(), QUERY, (10**9,))
    after = _get_json(ws_server.base, "/healthz")
    assert after["requests"] == before["requests"] + 1
    assert after["win_windows"] == before["win_windows"] + 3


def test_ws_auth_token(toy):
    ckpt, cfg_file, _ = toy
    s = WsServer(ckpt, cfg_file, "--auth_token", "ws-sekrit")
    try:
        assert _closed_with(s.ws_url) == 1008
        assert _closed_with(s.ws_url, additional_headers={
            "Authorization": "Bearer wrong"}) == 1008
        out, done = _ws_stream(s.ws_url, _pcm(1500).tobytes(), "seed=1&window=1024",
                               (3000,), token="ws-sekrit")
        assert out.shape == (1500,) and done["samples_out"] == 1500
    finally:
        s.stop()


def test_ws_client_tool_roundtrip(ws_server, tmp_path):
    """tools/ws_client.py: a WAV in, the streamed enhancement out, byte-identical to a
    direct WebSocket stream with the same seed."""
    from scipy.io import wavfile

    n = 2400
    pcm = _pcm(n, seed=3)
    wav_in, wav_out = tmp_path / "in.wav", tmp_path / "out.wav"
    wavfile.write(str(wav_in), 16000, pcm)
    r = subprocess.run(
        [sys.executable, "tools/ws_client.py", "--url", ws_server.ws_url, "--in",
         str(wav_in), "--out", str(wav_out), "--seed", "21", "--window", "1024",
         "--overlap", "0.25", "--piece_ms", "40", "--realtime", "4.0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    info = json.loads(r.stdout.strip().splitlines()[-1])
    assert info["samples_in"] == info["samples_out"] == n and not info["truncated"]
    rate, enh = wavfile.read(str(wav_out))
    direct, _ = _ws_stream(ws_server.ws_url, pcm.tobytes(),
                           "seed=21&window=1024&overlap=0.25", (10**9,))
    assert rate == 16000
    np.testing.assert_array_equal(enh, direct)


# -- the guards ---------------------------------------------------------------------------
def test_ws_session_cap_and_body_cap_truncate(toy, monkeypatch):
    """--max_stream_seconds finalises a session that outlives it, and the HTTP
    endpoint's body cap a session that sends more: each with a truncated "done"."""
    ckpt, cfg_file, _ = toy
    s = WsServer(ckpt, cfg_file, "--max_stream_seconds", "1.0", "--no_stream_coalesce")
    try:
        pcm = _pcm(4096, seed=1).tobytes()
        out, done = _ws_stream(s.ws_url, pcm, "seed=1&window=1024&overlap=0",
                               [len(pcm) // 16] * 16, gap=0.15)
        assert done["truncated"] is True and 0 < out.size == done["samples_out"] < 4096
        monkeypatch.setattr(serve, "MAX_BODY_BYTES", 3000)
        out, done = _ws_stream(s.ws_url, pcm, "seed=1&window=1024", [1000] * 4, gap=0.05)
        # the fourth frame passes the cap: the three before it are finalised
        assert done["truncated"] is True and out.size == done["samples_out"] == 1500
    finally:
        s.stop()


def test_ws_draining_finalises_a_session(ws_server):
    """A session sees "draining" at its next receive and ends with a truncated "done"."""
    from websockets.sync.client import connect

    pcm = _pcm(1024).tobytes()
    try:
        with connect(f"{ws_server.ws_url}?seed=1&window=1024", open_timeout=60) as ws:
            ws.send(pcm)
            msgs = [ws.recv(timeout=30)]  # the first window's samples: the audio is in
            assert len(msgs[0]) == 2 * 768
            ws_server.state["draining"] = True
            while not isinstance(msgs[-1], str):
                msgs.append(ws.recv(timeout=30))
    finally:
        ws_server.state["draining"] = False
    done = json.loads(msgs[-1])
    assert done["truncated"] is True and done["samples_out"] == 1024


def test_ws_active_sender_does_not_hold_the_drain(toy):
    """python -m segan_pytorch_tpu_torch.serve --ws_port: a client that never stops
    sending gets a truncated "done" after SIGTERM, and the process exits 0 (the
    connection threads of websockets.sync are not daemons)."""
    from websockets.sync.client import connect

    ckpt, cfg_file, _ = toy
    port, ws_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "segan_pytorch_tpu_torch.serve", "--g_pretrained_ckpt",
         str(ckpt), "--cfg_file", str(cfg_file), "--port", str(port), "--ws_port",
         str(ws_port), "--warm_seconds", "0.1", "--drain_seconds", "10", "--device", "cpu"],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 90
        while True:
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            try:
                if _get_json(f"http://127.0.0.1:{port}", "/healthz")["status"] == "ok":
                    break
            except OSError:
                assert time.time() < deadline, "the server never answered /healthz"
                time.sleep(0.2)
        got = {}

        def client():
            pcm = _pcm(1024).tobytes()
            with connect(f"ws://127.0.0.1:{ws_port}/enhance_stream?seed=1&window=1024",
                         open_timeout=60) as ws:
                got["connected"] = True
                for _ in range(1200):  # sends through the SIGTERM
                    ws.send(pcm)
                    try:
                        while True:
                            msg = ws.recv(timeout=0.02)
                            if isinstance(msg, str):
                                got["done"] = json.loads(msg)
                                return
                    except TimeoutError:
                        pass

        t = threading.Thread(target=client)
        t.start()
        while not got and t.is_alive():
            time.sleep(0.05)
        time.sleep(0.5)  # frames flow
        t0 = time.time()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert time.time() - t0 < 10
        t.join(timeout=30)
        assert not t.is_alive() and got["done"]["truncated"] is True, got
        log = proc.stdout.read()
        assert "websocket streaming on ws://" in log and "shutdown complete" in log, log
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


# -- TLS, and the server without the package ----------------------------------------------
def test_wss_with_mutual_tls(toy, tmp_path):
    """The WebSocket listener takes the HTTP listener's TLS context: wss, and a client
    without a certificate signed by --tls_client_ca fails."""
    import shutil

    from websockets.exceptions import ConnectionClosed, InvalidHandshake

    if shutil.which("openssl") is None:
        pytest.skip("the openssl command line is needed to mint test certificates")
    ckpt, cfg_file, _ = toy
    cert, key = _mint(tmp_path, "server", "localhost")
    cli = _mint(tmp_path, "client", "segan-client")
    s = WsServer(ckpt, cfg_file, "--tls_cert", str(cert), "--tls_key", str(key),
                 "--tls_client_ca", str(cli[0]))
    url = s.ws_url.replace("ws://", "wss://")
    try:
        # under TLS 1.3 the refusal may come after the client's handshake returns
        with pytest.raises((ssl.SSLError, OSError, InvalidHandshake, TimeoutError,
                            ConnectionClosed)):
            _ws_stream(url, _pcm(1500).tobytes(), "window=1024", (3000,),
                       ssl_ctx=_client_ctx())
        out, done = _ws_stream(url, _pcm(1500).tobytes(), "seed=1&window=1024", (3000,),
                               ssl_ctx=_client_ctx(cli))
        assert out.shape == (1500,) and done["samples_out"] == 1500
    finally:
        s.stop()


def test_wss_mutual_tls_connections_in_a_row(toy, tmp_path):
    """100 mutual-TLS sessions, each after a refused client: every upgrade is answered.
    With TLS 1.3 session tickets about one in 40 was lost, the listener closing it at its
    open timeout (``serve.tls_context``)."""
    import shutil

    from websockets.sync.client import connect

    if shutil.which("openssl") is None:
        pytest.skip("the openssl command line is needed to mint test certificates")
    ckpt, cfg_file, _ = toy
    cert, key = _mint(tmp_path, "server", "localhost")
    cli = _mint(tmp_path, "client", "segan-client")
    s = WsServer(ckpt, cfg_file, "--tls_cert", str(cert), "--tls_key", str(key),
                 "--tls_client_ca", str(cli[0]))
    url = s.ws_url.replace("ws://", "wss://") + "?window=1024"
    lost = []
    try:
        for i in range(100):
            try:
                with connect(url, open_timeout=10, ssl=_client_ctx()) as ws:
                    ws.send("end")
                    ws.recv(timeout=10)
            except Exception:
                pass  # refused: no client certificate
            try:
                with connect(url, open_timeout=20, ssl=_client_ctx(cli)) as ws:
                    ws.send("end")
                    done = json.loads(ws.recv(timeout=10))
                assert done["event"] == "done", done
            except Exception as e:
                lost.append((i, repr(e)))
        assert not lost, lost
    finally:
        s.stop()


def test_without_websockets_the_server_builds_and_ws_port_names_the_package(
        toy, monkeypatch):
    ckpt, cfg_file, _ = toy
    for name in [m for m in sys.modules if m.split(".")[0] == "websockets"] + ["websockets"]:
        monkeypatch.setitem(sys.modules, name, None)  # importing any of them fails
    s = Server(ckpt, cfg_file)
    try:
        assert _get_json(s.base, "/healthz")["ws_port"] == 0
    finally:
        s.stop()
    with pytest.raises(ImportError, match="websockets"):
        Server(ckpt, cfg_file, "--ws_port", str(_free_port()))


# -- the parser, and the copy of G that threads share --------------------------------------
def _root_parser():
    """serve.py's parser, which its main() builds and parses with at once."""
    class Built(Exception):
        pass

    def capture(self, *a, **k):
        raise Built(self)

    root = _root_serve()
    parse = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(Built) as ei:
            root.main()
    finally:
        argparse.ArgumentParser.parse_args = parse
    return ei.value.args[0]


def test_parser_equals_serve_py():
    """Every option of serve.py, with its spelling, default, arity, type and choices,
    plus the port's --device; help texts aside."""
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices,
                         a.required, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    want, got = options(_root_parser()), options(serve.build_parser())
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want


def test_bf16_copy_of_g_is_built_once_by_concurrent_threads():
    """The threads that run G (batchers, and a handler or WebSocket thread that runs a
    session's windows with --no_stream_coalesce) share one compute-dtype copy."""
    seg = SEGAN(SEGANConfig(**TOY, no_bias=True, compute_dtype="bfloat16"), device="cpu")
    got, interval = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: got.append(seg._g())) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts) and len(got) == 16
    assert all(g is got[0] for g in got) and got[0] is not seg.G
    assert next(got[0].parameters()).dtype == torch.bfloat16
