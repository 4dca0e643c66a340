"""Enhancement server of the port: the request path of the repo's ``serve.py``.

    python -m segan_pytorch_tpu_torch.serve --g_pretrained_ckpt G.ckpt \\
        --cfg_file train.opts --port 8080 [--device cpu]

It loads the engine as ``clean`` does (train.opts and a checkpoint, through
``utils/engine.py``), runs one warm-up enhancement, then serves:

  GET  /healthz         JSON {status, model, slice_size, warm_s, requests, batches, ...}
                        (batches < requests when concurrent requests were coalesced);
                        open without a token, for load balancers
  GET  /metrics         Prometheus text: requests, G passes, stream window passes and
                        windows, requests in flight, reloads, enhance seconds, draining;
                        open like /healthz
  POST /enhance         body: a 16 kHz WAV of any sample type; answer: the enhanced WAV.
                        Query: format=float|pcm16 (default float), seed=<int> (a
                        deterministic z), overlap=<0..0.5) (chunk cross-fade)
  POST /enhance_stream  body: raw 16 kHz PCM16 (little-endian), chunked or with a
                        Content-Length; answer: chunked PCM16, emitted as the audio
                        arrives (at most window + hop samples late). Query: seed,
                        overlap (default 0.25), window (samples; must divide by G's
                        pooling)
  POST /admin/reload    501: not ported yet (ROADMAP A5b)

Concurrent /enhance requests are coalesced into one G forward by a ``MicroBatcher``,
and the windows of concurrent streams into shared forwards by a ``WindowBatcher``
(``--no_stream_coalesce``: one forward per session and window). ``--auth_token`` (or
$SEGAN_SERVE_TOKEN) gates the POST endpoints behind 'Authorization: Bearer <token>'.
SIGTERM or SIGINT drains: the listener closes, requests in flight get up to
``--drain_seconds`` to finish, and the process exits 0.

``seed=<int>`` draws z from ``torch.Generator().manual_seed(seed)``: an answer is
deterministic per seed, and it is not the JAX server's answer for that seed (whose z
comes from ``jax.random``). It runs on the CUDA card, and raises without one; ``--device
cpu`` asks for the CPU. TLS, mutual TLS, the WebSocket listener and ``/admin/reload`` are
not ported yet: their options raise ``NotImplementedError``.
"""
import argparse
import hmac
import io
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote

import numpy as np
import torch

# ~1 hour of 16 kHz float64 audio as a WAV body: far above any sane request, far below
# what could wedge the host's allocator
MAX_BODY_BYTES = 512 * 1024 * 1024
DEFERRED = "not ported yet (ROADMAP A5b)"


class InflightCounter:
    """Counts requests currently being handled, so a SIGTERM drain can wait for work in
    flight instead of cutting passes mid-response."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def __enter__(self):
        with self._lock:
            self._n += 1
        return self

    def __exit__(self, *exc):
        with self._lock:
            self._n -= 1
        return False

    def count(self):
        with self._lock:
            return self._n


def _parse_params(query: str) -> dict:
    """Query-string params as a dict (URL-decoded)."""
    params = {}
    for kv in query.split("&"):
        if "=" in kv:
            k, _, v = kv.partition("=")
            params[unquote(k)] = unquote(v)
    return params


def _as_int16(wav):
    """Coerce any scipy-wavfile sample dtype to int16 scale, so the int16-domain
    normalize_wave_minmax applies uniformly (float WAVs come back in [-1, 1], int32 at
    ±2^31, uint8 at 0..255)."""
    wav = np.asarray(wav)
    if wav.ndim > 1:
        wav = wav[:, 0]  # first channel of multi-channel input
    if wav.dtype == np.int16:
        return wav
    if wav.dtype in (np.float32, np.float64):
        return (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    if wav.dtype == np.int32:
        return (wav >> 16).astype(np.int16)
    if wav.dtype == np.uint8:
        return ((wav.astype(np.int16) - 128) << 8).astype(np.int16)
    raise ValueError(f"unsupported wav dtype {wav.dtype}")


def _seed_rng(seed):
    return None if seed is None else torch.Generator().manual_seed(seed)


def make_handler(cfg, segan, state):
    from scipy.io import wavfile as _wavfile

    from .ops.signal import normalize_wave_minmax, pre_emphasize_np
    from .utils.serving import MicroBatcher, StreamingEnhancer, WindowBatcher

    # (cfg, engine, batcher, win_batcher) as ONE tuple: a request reads state["gen"] once
    # and uses one generation throughout (the reload of ROADMAP A5b swaps it whole).
    # win_batcher coalesces concurrent streams' window forwards (None with
    # --no_stream_coalesce: one forward per session, whatever the load)
    wb0 = WindowBatcher(segan) if state.get("stream_coalesce", True) else None
    if wb0 is not None and float(state.get("warm_seconds", 0)) > 0:
        t0 = time.perf_counter()
        wb0.warm(cfg.slice_size, max_rows=8)
        if state["verbose"]:
            print(f"[serve] stream-batch warm-up: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    state["gen"] = (cfg, segan, MicroBatcher(
        segan, target_batch_seconds=state.get("target_batch_seconds", 0.0)), wb0)
    state.setdefault("reloads", 0)
    state.setdefault("enh_seconds_sum", 0.0)
    state["mlock"] = threading.Lock()  # the request counters and sums
    max_stream_s = float(state.get("max_stream_seconds", 0.0))
    auth_token = state.get("auth_token") or ""
    inflight = state["inflight"]

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet unless --verbose
            if state["verbose"]:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        def _json(self, code, obj, extra_headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra_headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self):
            """Bearer-token gate of the POST endpoints, compared in constant time as
            bytes (compare_digest on str raises on non-ASCII). An unauthorized request's
            body is never read, so its connection must close."""
            if not auth_token:
                return True
            header = self.headers.get("Authorization", "")
            return (header.startswith("Bearer ")
                    and hmac.compare_digest(header[7:].encode("utf-8"),
                                            auth_token.encode("utf-8")))

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/metrics":
                return self._metrics()
            if path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            c, eng, bt, wb = state["gen"]
            with state["mlock"]:
                requests = state["requests"]
            self._json(200, {
                "status": "draining" if state.get("draining") else "ok",
                "model": type(eng).__name__,  # the engine's class, not the flags
                "slice_size": c.slice_size,
                "warm_s": state["warm_s"],
                "requests": requests,
                "batches": bt.batches,
                "batch_chunk_budget": bt.effective_max_chunks,
                "stream_coalesce": wb is not None,
                "win_batches": wb.batches if wb else 0,
                "win_windows": wb.windows if wb else 0,
                "inflight": inflight.count(),
                "auth": bool(auth_token),
                "reloads": state["reloads"],
                "ws_port": 0,
            })

        def _metrics(self):
            """Prometheus text exposition, with the names of serve.py's."""
            bt, wb = state["gen"][2], state["gen"][3]
            with state["mlock"]:
                enh_sum, requests = state["enh_seconds_sum"], state["requests"]
            lines = [
                "# TYPE segan_requests_total counter",
                f"segan_requests_total {requests}",
                "# TYPE segan_device_passes_total counter",
                f"segan_device_passes_total {bt.batches}",
                "# TYPE segan_stream_window_passes_total counter",
                f"segan_stream_window_passes_total {wb.batches if wb else 0}",
                "# TYPE segan_stream_windows_total counter",
                f"segan_stream_windows_total {wb.windows if wb else 0}",
                "# TYPE segan_inflight_requests gauge",
                f"segan_inflight_requests {inflight.count()}",
                "# TYPE segan_reloads_total counter",
                f"segan_reloads_total {state['reloads']}",
                "# TYPE segan_enhance_seconds_sum counter",
                f"segan_enhance_seconds_sum {enh_sum:.6f}",
                "# TYPE segan_draining gauge",
                f"segan_draining {int(bool(state.get('draining')))}",
            ]
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _params(self):
            _, _, query = self.path.partition("?")
            return _parse_params(query)

        def do_POST(self):
            if not self._authorized():
                self.close_connection = True  # body unread: no keep-alive
                return self._json(401, {"error": "unauthorized"},
                                  extra_headers=[("WWW-Authenticate", "Bearer"),
                                                 ("Connection", "close")])
            with inflight:
                try:
                    return self._do_post()
                finally:
                    if state.get("draining"):
                        # keep-alive connections must not outlive the drain
                        self.close_connection = True

        def _do_post(self):
            path, _, _ = self.path.partition("?")
            chunked = "chunked" in (self.headers.get("Transfer-Encoding") or "").lower()
            if path == "/enhance_stream":
                return self._enhance_stream(self._params(), chunked)
            # /enhance needs a Content-Length to drain the body under keep-alive
            if chunked:
                self.close_connection = True
                return self._json(501, {"error": "chunked transfer encoding only "
                                                 "supported on /enhance_stream"})
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = 0
            if n > MAX_BODY_BYTES:
                self.close_connection = True  # don't drain a hostile body
                return self._json(413, {"error": f"body too large ({n} bytes; "
                                                 f"max {MAX_BODY_BYTES})"})
            # drain the body first: under keep-alive an unread body would be parsed as
            # the next request line on the same connection
            raw = self.rfile.read(n)
            if path == "/admin/reload":
                return self._json(501, {"error": f"/admin/reload: {DEFERRED}"})
            if path != "/enhance":
                return self._json(404, {"error": "unknown path"})
            params = self._params()
            # client-input validation -> 400 (before the model's 500 umbrella)
            try:
                overlap = float(params.get("overlap", 0.0))
                seed = int(params["seed"]) if "seed" in params else None
            except ValueError as e:
                return self._json(400, {"error": f"bad query param: {e}"})
            if not (0.0 <= overlap < 0.5):
                return self._json(400, {"error": "overlap must be in [0, 0.5)"})
            try:
                rate, wav = _wavfile.read(io.BytesIO(raw))
            except Exception as e:  # any parse failure of the client's bytes
                return self._json(400, {"error": f"bad wav: {e}"})
            if rate != 16000:
                return self._json(400, {"error": f"expected 16 kHz, got {rate}"})
            gen_cfg, _, gen_batcher, _ = state["gen"]  # one generation
            try:
                pwav = pre_emphasize_np(normalize_wave_minmax(_as_int16(wav)),
                                        gen_cfg.preemph)
            except ValueError as e:  # unsupported sample dtype etc.
                return self._json(400, {"error": str(e)})
            try:
                t0 = time.perf_counter()
                # concurrent requests coalesce into one G pass
                enh = gen_batcher.enhance(pwav, rng=_seed_rng(seed), overlap=overlap)
                dt = time.perf_counter() - t0
                with state["mlock"]:
                    state["requests"] += 1
                    state["enh_seconds_sum"] += dt
            except Exception as e:  # a model error is a 500; the server keeps serving
                return self._json(500, {"error": str(e)})
            buf = io.BytesIO()
            if params.get("format") == "pcm16":
                _wavfile.write(buf, 16000,
                               np.clip(enh * 32767.0, -32768, 32767).astype(np.int16))
            else:
                _wavfile.write(buf, 16000, enh.astype(np.float32))
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Enhance-Seconds", f"{dt:.4f}")
            self.end_headers()
            self.wfile.write(body)

        def _drain_input_bounded(self, max_bytes=8 * 1024 * 1024, timeout_s=2.0):
            """Discard up to max_bytes of pending request body (short socket timeout):
            closing with unread data makes Linux send RST, which can drop the response
            already written; a bounded drain avoids that without letting a hostile
            client stream forever."""
            try:
                self.connection.settimeout(timeout_s)
                left = max_bytes
                while left > 0:
                    got = self.rfile.read(min(left, 65536))
                    if not got:
                        break
                    left -= len(got)
            except (OSError, ValueError):
                pass

        # ---- streaming: raw PCM16 in (chunked or sized), chunked PCM16 out ----
        def _incoming_pieces(self, chunked):
            if chunked:
                total = 0
                while True:
                    line = self.rfile.readline(1026)
                    try:
                        size = int(line.split(b";")[0].strip() or b"0", 16)
                    except ValueError:
                        raise ValueError("bad chunk framing")
                    if size == 0:
                        self.rfile.readline()  # trailing CRLF after the last chunk
                        return
                    total += size
                    if total > MAX_BODY_BYTES:
                        raise ValueError("stream too large")
                    data = self.rfile.read(size)
                    self.rfile.read(2)  # CRLF
                    yield data
            else:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    raise ValueError("stream too large")
                # pieces, so that enhancement overlaps the arrival of later audio
                left = n
                while left > 0:
                    piece = self.rfile.read(min(left, 65536))
                    if not piece:
                        return
                    left -= len(piece)
                    yield piece

        def _write_chunk(self, data: bytes):
            # one socket write per HTTP chunk (framing, payload, CRLF)
            if data:
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

        def _enhance_stream(self, params, chunked):
            gen_cfg, gen_engine, _, gen_wb = state["gen"]  # one generation
            try:
                overlap = float(params.get("overlap", 0.25))
                window = int(params.get("window", gen_cfg.slice_size))
                seed = int(params["seed"]) if "seed" in params else None
            except ValueError as e:
                self.close_connection = True
                return self._json(400, {"error": f"bad query param: {e}"})
            try:
                streamer = StreamingEnhancer(gen_engine, window=window, overlap=overlap,
                                             rng=_seed_rng(seed), batcher=gen_wb)
            except ValueError as e:  # bad window or overlap
                self.close_connection = True
                return self._json(400, {"error": str(e)})
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Stream-Latency-Samples", str(streamer.latency_samples))
            self.end_headers()
            # a silent client must not pin this thread: the session guard below runs
            # only when a piece arrives, so the reads themselves get a timeout
            if max_stream_s > 0:
                self.connection.settimeout(min(60.0, max_stream_s))
            carry = b""
            t0 = time.perf_counter()
            n_out = 0
            truncated = False
            try:
                try:
                    for piece in self._incoming_pieces(chunked):
                        if max_stream_s > 0 and time.perf_counter() - t0 > max_stream_s:
                            # session guard: finalize what was fed and drop the
                            # connection (its unread body rules out keep-alive)
                            truncated = True
                            break
                        carry += piece
                        usable = len(carry) - (len(carry) % 2)
                        if not usable:
                            continue
                        pcm = np.frombuffer(carry[:usable], dtype="<i2")
                        carry = carry[usable:]
                        out = streamer.feed(normalize_wave_minmax(pcm))
                        pcm_out = np.clip(out * 32767.0, -32768, 32767).astype("<i2")
                        n_out += pcm_out.size
                        self._write_chunk(pcm_out.tobytes())
                except TimeoutError:
                    # silent client: finalize what was fed, as at the session limit
                    truncated = True
                out = streamer.flush()
                pcm_out = np.clip(out * 32767.0, -32768, 32767).astype("<i2")
                n_out += pcm_out.size
                self._write_chunk(pcm_out.tobytes())
                self.wfile.write(b"0\r\n\r\n")
                if truncated:
                    # against a TCP RST racing the last chunks: drain what the client
                    # already sent before the close
                    self._drain_input_bounded()
                    self.close_connection = True
                with state["mlock"]:
                    state["requests"] += 1
                if state["verbose"]:
                    print(f"[serve] stream: {n_out} samples in "
                          f"{time.perf_counter() - t0:.3f}s (window {window}, overlap "
                          f"{overlap}{', truncated at the session limit' if truncated else ''})",
                          flush=True)
            except (ValueError, ConnectionError, TimeoutError) as e:
                # mid-stream failure (bad framing, client gone, a stalled write): the
                # headers are out, so the only recovery is to drop the connection
                if state["verbose"]:
                    print(f"[serve] stream aborted: {e}", flush=True)
                self.close_connection = True

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--g_pretrained_ckpt", required=True)
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--warm_seconds", type=float, default=2.0,
                   help="seconds of silence enhanced once before accepting traffic, "
                        "with a streaming pass of each power-of-two row count up to 8 "
                        "(0 = off)")
    p.add_argument("--max_stream_seconds", type=float, default=3600.0,
                   help="wall-clock cap per /enhance_stream session; past it the stream "
                        "is finalized and the connection closed (0 = unlimited)")
    p.add_argument("--target_batch_seconds", type=float, default=0.0,
                   help=">0: adapt the MicroBatcher's chunk budget so that one "
                        "coalesced pass stays under this latency (0 = fixed budget)")
    p.add_argument("--no_stream_coalesce", action="store_true",
                   help="one G forward per streaming session and window, instead of "
                        "shared passes; a session's output then does not depend on the "
                        "concurrent load")
    p.add_argument("--auth_token", default=None,
                   help="require 'Authorization: Bearer <token>' on the POST endpoints "
                        "(/healthz and /metrics stay open); defaults to "
                        "$SEGAN_SERVE_TOKEN when set")
    p.add_argument("--drain_seconds", type=float, default=30.0,
                   help="on SIGTERM/SIGINT: stop accepting connections, wait up to this "
                        "long for requests in flight, then exit 0")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default) needs a card; cpu runs the plain PyTorch "
                        "versions of the kernels")
    p.add_argument("--verbose", action="store_true")
    for flag in ("--tls_cert", "--tls_key", "--tls_client_ca"):
        p.add_argument(flag, default=None, help=DEFERRED)
    p.add_argument("--ws_port", type=int, default=0, help=DEFERRED)
    p.add_argument("--ws_ping_interval", type=float, default=None, help=DEFERRED)
    return p


def deferred_options(opts) -> list:
    """The options given that the port does not serve yet, as flags."""
    return [flag for flag, value in (("--tls_cert", opts.tls_cert),
                                     ("--tls_key", opts.tls_key),
                                     ("--tls_client_ca", opts.tls_client_ca),
                                     ("--ws_port", opts.ws_port),
                                     ("--ws_ping_interval", opts.ws_ping_interval))
            if value]


def build_server(opts):
    """Load and warm the engine and bind the listener: (server, state). The caller runs
    ``server.serve_forever()``, and ``close(server, state)`` when it returns."""
    deferred = deferred_options(opts)
    if deferred:
        raise NotImplementedError(f"{', '.join(deferred)}: {DEFERRED}")
    from .models.segan import default_device
    from .utils.engine import build_enhancement_engine

    device = default_device() if opts.device == "cuda" else torch.device("cpu")
    cfg, segan = build_enhancement_engine(opts.cfg_file, opts.g_pretrained_ckpt, opts.seed,
                                          device=device)
    state = {"warm_s": 0.0, "requests": 0, "verbose": opts.verbose,
             "max_stream_seconds": opts.max_stream_seconds,
             "target_batch_seconds": opts.target_batch_seconds,
             "stream_coalesce": not opts.no_stream_coalesce,
             "auth_token": opts.auth_token or os.environ.get("SEGAN_SERVE_TOKEN", ""),
             "inflight": InflightCounter(), "draining": False,
             "warm_seconds": opts.warm_seconds}
    if opts.warm_seconds > 0:
        t0 = time.perf_counter()
        segan.generate(np.zeros(int(16000 * opts.warm_seconds), np.float32))
        state["warm_s"] = round(time.perf_counter() - t0, 3)
        print(f"[serve] warm-up done in {state['warm_s']} s", flush=True)
    srv = ThreadingHTTPServer((opts.host, opts.port), make_handler(cfg, segan, state))
    return srv, state


def close(srv, state):
    """Close the listener and stop the batchers' worker threads."""
    srv.server_close()
    _, _, batcher, win_batcher = state["gen"]
    batcher.close()
    if win_batcher is not None:
        win_batcher.close()


def main(argv=None):
    opts = build_parser().parse_args(argv)
    srv, state = build_server(opts)
    inflight = state["inflight"]

    def _graceful_stop(signum, _frame):
        state["draining"] = True
        print(f"[serve] signal {signum}: draining (up to {opts.drain_seconds:.0f}s for "
              f"requests in flight)", flush=True)
        # shutdown() waits for serve_forever to return, and this handler runs on the
        # main thread, inside serve_forever
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful_stop)
    signal.signal(signal.SIGINT, _graceful_stop)
    host, port = srv.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} (slice_size "
          f"{state['gen'][0].slice_size}{', auth required' if state['auth_token'] else ''})",
          flush=True)
    srv.serve_forever()
    # close the listening socket now, so that new clients are refused at once instead
    # of waiting in the backlog through the drain; established connections go on
    srv.socket.close()
    # a grace for requests accepted before the signal but not yet counted, then wait
    # for the ones in flight; handler threads are daemons, so the exit reaps whatever
    # misses the deadline
    deadline = time.time() + max(0.0, opts.drain_seconds)
    time.sleep(min(1.0, max(0.0, opts.drain_seconds)))
    while inflight.count() > 0 and time.time() < deadline:
        time.sleep(0.05)
    n = inflight.count()
    close(srv, state)
    print(f"[serve] shutdown complete"
          f"{f' ({n} request(s) abandoned at the drain deadline)' if n else ''}", flush=True)


if __name__ == "__main__":
    main()
