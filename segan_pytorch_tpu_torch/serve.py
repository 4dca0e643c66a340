"""Enhancement server of the port: the counterpart of the repo's ``serve.py``.

    python -m segan_pytorch_tpu_torch.serve --g_pretrained_ckpt G.ckpt \\
        --cfg_file train.opts --port 8080 [--device cpu] [--ws_port 8081] \\
        [--tls_cert cert.pem --tls_key key.pem [--tls_client_ca ca.pem]]

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
  POST /admin/reload    body: JSON {"g_ckpt": path[, "cfg_file": path]}: builds and warms
                        a new generation (engine and batchers) on the server's device,
                        then swaps it in whole; requests that took the old one finish on
                        it, and its batchers close RETIRE_SECONDS later. A failed build
                        answers 500 and the old generation goes on serving
  WS   /enhance_stream  (--ws_port) the stream over a WebSocket: binary PCM16 frames in
                        and out, a text frame "end" (or "flush") finalises and is answered
                        with a JSON "done" frame; the server pings every
                        --ws_ping_interval seconds, so idle input gaps do not drop the
                        session at a NAT or load balancer. Same query, token and TLS

Concurrent /enhance requests are coalesced into one G forward by a ``MicroBatcher``,
and the windows of concurrent streams into shared forwards by a ``WindowBatcher``
(``--no_stream_coalesce``: one forward per session and window). ``--auth_token`` (or
$SEGAN_SERVE_TOKEN) gates the POST endpoints and the WebSocket behind 'Authorization:
Bearer <token>'. ``--tls_cert``/``--tls_key`` serve HTTPS (and wss), the handshake
deferred to the handler thread; ``--tls_client_ca`` demands a client certificate signed
by that CA on both listeners (mutual TLS). SIGTERM or SIGINT drains: the listeners
close, requests and sessions in flight get up to ``--drain_seconds`` to finish, and the
process exits 0.

``seed=<int>`` draws z from ``torch.Generator().manual_seed(seed)``: an answer is
reproducible per seed (on the card up to the summation order of cuDNN's fp32 transposed
convs, which ``torch.backends.cudnn.deterministic`` fixes at a price), the WebSocket
stream's PCM equals the chunked-HTTP stream's, and neither is the JAX server's answer for
that seed (whose z comes from ``jax.random``). It
runs on the CUDA card, and raises without one; ``--device cpu`` asks for the CPU. The
``websockets`` package is imported only under ``--ws_port``.
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
# the largest sized body that a 401 reads before it answers and closes (a larger one is
# left unread: the client may see a reset instead of the answer)
UNAUTHORIZED_DRAIN_BYTES = 8 * 1024 * 1024
# seconds that a generation replaced by /admin/reload keeps its batchers open for the
# requests that took it before the swap (their enhance timeout is 120 s)
RETIRE_SECONDS = 150
WS_MAX_FRAME = 16 * 1024 * 1024  # bytes of one WebSocket message, at most


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


def _authorized(header: str, token: str) -> bool:
    """The bearer-token gate of the POST endpoints and the WebSocket, compared in constant
    time as bytes (compare_digest on str raises on non-ASCII)."""
    if not token:
        return True
    return (header.startswith("Bearer ")
            and hmac.compare_digest(header[7:].encode("utf-8"), token.encode("utf-8")))


def new_state(opts, device) -> dict:
    """The server's settings and counters from its options, with no generation yet."""
    return {"warm_s": 0.0, "requests": 0, "verbose": opts.verbose,
            "max_stream_seconds": opts.max_stream_seconds,
            "target_batch_seconds": opts.target_batch_seconds,
            "stream_coalesce": not opts.no_stream_coalesce,
            "auth_token": opts.auth_token or os.environ.get("SEGAN_SERVE_TOKEN", ""),
            "inflight": InflightCounter(), "draining": False,
            "cfg_file": opts.cfg_file, "seed": opts.seed, "device": device,
            "warm_seconds": opts.warm_seconds, "ws_port": opts.ws_port,
            "reloads": 0, "enh_seconds_sum": 0.0,
            # passes of the generations that reloads replaced
            "batches_prev": 0, "win_batches_prev": 0, "win_windows_prev": 0,
            "mlock": threading.Lock(),        # the counters and sums
            "reload_lock": threading.Lock(),  # one reload at a time, and close()
            "closed": threading.Event(),      # set by close(): retire at once
            "retiring": []}                   # the retire threads


def build_generation(state, cfg_file, g_ckpt):
    """A serving generation, (cfg, engine, batcher, win_batcher), built on the server's
    device and warmed before anyone can take it: a ``generate()`` of ``warm_seconds`` of
    silence (it pads the kernel's weights, builds the bf16 copy and cuDNN's plans), the
    ``MicroBatcher`` (whose constructor builds the compute-dtype copy before its thread
    starts) and, unless streams are not coalesced, a ``WindowBatcher`` warmed at
    ``slice_size`` up to 8 rows. Returns (generation, seconds: {"load", "warm",
    "warm_generate"}): "warm" spans all of the warm-up, "warm_generate" the ``generate()``
    alone (``/healthz``'s ``warm_s``, as root ``serve.py`` times it); what was built is
    closed again if a later step raises."""
    from .utils.engine import build_enhancement_engine
    from .utils.serving import MicroBatcher, WindowBatcher

    t0 = time.perf_counter()
    cfg, engine = build_enhancement_engine(cfg_file, g_ckpt, state["seed"],
                                           device=state["device"])
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    warm = float(state["warm_seconds"])
    batcher = win_batcher = None
    t_gen = 0.0
    try:
        if warm > 0:
            engine.generate(np.zeros(int(16000 * warm), np.float32))
            t_gen = time.perf_counter() - t1
        batcher = MicroBatcher(engine, target_batch_seconds=state["target_batch_seconds"])
        if state["stream_coalesce"]:
            win_batcher = WindowBatcher(engine)
            if warm > 0:
                win_batcher.warm(cfg.slice_size, max_rows=8)
    except BaseException:
        close_generation((cfg, engine, batcher, win_batcher))
        raise
    return (cfg, engine, batcher, win_batcher), {"load": t1 - t0,
                                                 "warm": time.perf_counter() - t1,
                                                 "warm_generate": t_gen}


def close_generation(gen):
    """Stop a generation's batcher threads."""
    for b in gen[2:]:
        if b is not None:
            b.close()


def swap_generation(state, gen, cfg_file):
    """Publish `gen` in one assignment and retire the generation it replaces. The old
    batchers' pass counts fold into the *_prev counters at once, so that /metrics never
    goes back; the batchers close RETIRE_SECONDS later (at once under ``close``) on a
    daemon thread, which then folds in the passes they made after the swap. The caller
    holds state["reload_lock"]."""
    _, _, old_b, old_w = state["gen"]
    state["cfg_file"] = cfg_file
    with state["mlock"]:  # the counters' readers see the swap and the fold together
        state["gen"] = gen
        state["reloads"] += 1
        swapped = (old_b.batches, old_w.batches if old_w else 0,
                   old_w.windows if old_w else 0)
        state["batches_prev"] += swapped[0]
        state["win_batches_prev"] += swapped[1]
        state["win_windows_prev"] += swapped[2]
    t = threading.Thread(target=_retire, args=(state, old_b, old_w, swapped), daemon=True,
                         name="batcher-retire")
    state["retiring"] = [r for r in state["retiring"] if r.is_alive()] + [t]
    t.start()


def _retire(state, batcher, win_batcher, swapped):
    state["closed"].wait(RETIRE_SECONDS)
    try:
        close_generation((None, None, batcher, win_batcher))
    finally:
        with state["mlock"]:
            state["batches_prev"] += batcher.batches - swapped[0]
            if win_batcher is not None:
                state["win_batches_prev"] += win_batcher.batches - swapped[1]
                state["win_windows_prev"] += win_batcher.windows - swapped[2]


def _counters(state):
    """(requests, G passes, stream window passes, stream windows, enhance seconds,
    reloads) over every generation: the retired ones' and the current batchers'."""
    with state["mlock"]:
        _, _, bt, wb = state["gen"]
        return (state["requests"], state["batches_prev"] + bt.batches,
                state["win_batches_prev"] + (wb.batches if wb else 0),
                state["win_windows_prev"] + (wb.windows if wb else 0),
                state["enh_seconds_sum"], state["reloads"])


def make_handler(state):
    """The HTTP handler class over state["gen"], the generation being served."""
    from scipy.io import wavfile as _wavfile

    from .ops.signal import normalize_wave_minmax, pre_emphasize_np
    from .utils.serving import StreamingEnhancer

    # state["gen"], (cfg, engine, batcher, win_batcher), is ONE tuple: a request reads it
    # once and uses one generation throughout, and a reload swaps it whole. win_batcher
    # coalesces concurrent streams' window forwards (None with --no_stream_coalesce: one
    # forward per session, whatever the load)
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


        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/metrics":
                return self._metrics()
            if path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            c, eng, bt, wb = state["gen"]
            requests, passes, win_passes, windows, _, reloads = _counters(state)
            self._json(200, {
                "status": "draining" if state.get("draining") else "ok",
                "model": type(eng).__name__,  # the engine's class, not the flags
                "slice_size": c.slice_size,
                "warm_s": state["warm_s"],
                "requests": requests,
                "batches": passes,
                "batch_chunk_budget": bt.effective_max_chunks,
                "stream_coalesce": wb is not None,
                "win_batches": win_passes,
                "win_windows": windows,
                "inflight": inflight.count(),
                "auth": bool(auth_token),
                "reloads": reloads,
                "ws_port": state["ws_port"],
            })

        def _metrics(self):
            """Prometheus text exposition, with the names of serve.py's."""
            requests, passes, win_passes, windows, enh_sum, reloads = _counters(state)
            lines = [
                "# TYPE segan_requests_total counter",
                f"segan_requests_total {requests}",
                "# TYPE segan_device_passes_total counter",
                f"segan_device_passes_total {passes}",
                "# TYPE segan_stream_window_passes_total counter",
                f"segan_stream_window_passes_total {win_passes}",
                "# TYPE segan_stream_windows_total counter",
                f"segan_stream_windows_total {windows}",
                "# TYPE segan_inflight_requests gauge",
                f"segan_inflight_requests {inflight.count()}",
                "# TYPE segan_reloads_total counter",
                f"segan_reloads_total {reloads}",
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
            if not _authorized(self.headers.get("Authorization", ""), auth_token):
                # no keep-alive. A sized body (up to the drain's bound) is read first: a
                # close with unread data resets the connection, which can drop the answer
                # under the client's read
                self.close_connection = True
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    n = 0
                if 0 < n <= UNAUTHORIZED_DRAIN_BYTES:
                    self._drain_input_bounded(max_bytes=n)
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
                return self._admin_reload(raw)
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

        def _admin_reload(self, raw: bytes):
            """Build and warm a new generation, then swap it in (see ``swap_generation``);
            a failed build answers 500 and leaves the old generation serving."""
            try:
                req = json.loads(raw or b"{}")
            except ValueError as e:
                return self._json(400, {"error": f"bad json: {e}"})
            g_ckpt = req.get("g_ckpt") if isinstance(req, dict) else None
            if not g_ckpt:
                return self._json(400, {"error": "missing 'g_ckpt'"})
            cfg_file = req.get("cfg_file") or state["cfg_file"]
            with state["reload_lock"]:  # one reload at a time
                if state["closed"].is_set():
                    return self._json(503, {"error": "server closed"})
                try:
                    gen, seconds = build_generation(state, cfg_file, g_ckpt)
                except Exception as e:  # a bad path or checkpoint: keep serving
                    return self._json(500, {"error": f"reload failed: {e}"})
                swap_generation(state, gen, cfg_file)
                reloads = state["reloads"]
            if state["verbose"]:
                print(f"[serve] reloaded {type(gen[1]).__name__} from {g_ckpt} (load "
                      f"{seconds['load']:.2f} s, warm-up {seconds['warm']:.2f} s)",
                      flush=True)
            return self._json(200, {"status": "reloaded", "g_ckpt": g_ckpt,
                                    "reloads": reloads,
                                    "seconds": {k: round(v, 4) for k, v in seconds.items()}})

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


def make_ws_handler(state):
    """The WebSocket /enhance_stream (``--ws_port``): the session handler of a
    ``websockets.sync`` server. Unlike chunked HTTP it keeps a stream through input gaps
    of any length (the server pings). Protocol:

      client -> server  binary frame: raw 16 kHz PCM16 LE audio, any size
                        text frame "end" (or "flush"): finalise the stream
      server -> client  binary frame: enhanced PCM16 as samples become final
                        text frame (after "end"): JSON {"event": "done", "samples_out": N,
                        "truncated": bool}, then a clean close

    The token, the query (seed, overlap, window), the session's z, the emission rule and
    the max_stream_seconds cap are the HTTP endpoint's, through the same
    StreamingEnhancer: for one seed both give the same PCM, byte for byte. A bad token, an
    unknown path or a bad query closes with code 1008."""
    import socket
    import struct

    from websockets.exceptions import ConnectionClosed

    from .ops.signal import normalize_wave_minmax
    from .utils.serving import StreamingEnhancer

    auth_token = state.get("auth_token") or ""
    max_stream_s = float(state.get("max_stream_seconds", 0.0))
    inflight = state["inflight"]

    def handler(ws):
        if not _authorized(ws.request.headers.get("Authorization", ""), auth_token):
            ws.close(code=1008, reason="unauthorized")
            return
        path, _, query = ws.request.path.partition("?")
        if path != "/enhance_stream":
            ws.close(code=1008, reason="unknown path")
            return
        gen_cfg, gen_engine, _, gen_wb = state["gen"]  # one generation
        # bound the sends: a client that stops reading would hold this (non-daemon)
        # connection thread in sendall past the drain. SO_SNDTIMEO times out sends only;
        # a plain settimeout would also cut the reader during idle gaps, which the pings
        # allow. A send that times out raises OSError and ends the session
        send_timeout = min(60.0, max_stream_s) if max_stream_s > 0 else 60.0
        ws.socket.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                             struct.pack("ll", int(send_timeout), 0))
        try:
            params = _parse_params(query)
            overlap = float(params.get("overlap", 0.25))
            window = int(params.get("window", gen_cfg.slice_size))
            seed = int(params["seed"]) if "seed" in params else None
            streamer = StreamingEnhancer(gen_engine, window=window, overlap=overlap,
                                         rng=_seed_rng(seed), batcher=gen_wb)
        except ValueError as e:  # bad query param, window or overlap
            ws.close(code=1008, reason=str(e)[:120])
            return
        with inflight:
            carry = b""
            t0 = time.perf_counter()
            n_in = n_out = 0
            truncated = False
            while True:
                # checked on every receive, not only on a timeout: a client that never
                # stops sending must not hold the process past --drain_seconds
                if state.get("draining"):
                    truncated = True
                    break
                remaining = (max_stream_s - (time.perf_counter() - t0)
                             if max_stream_s > 0 else 1e9)
                if remaining <= 0:
                    truncated = True
                    break
                try:
                    msg = ws.recv(timeout=min(remaining, 1.0))
                except TimeoutError:
                    continue  # an idle gap: the pings hold the connection
                except ConnectionClosed:
                    return  # gone without "end": nobody to finalise to
                if isinstance(msg, str):
                    if msg.strip().lower() in ("end", "flush"):
                        break
                    continue  # other text frames are ignored
                n_in += len(msg)
                if n_in > MAX_BODY_BYTES:  # the HTTP endpoint's cap
                    truncated = True
                    break
                carry += msg
                usable = len(carry) - (len(carry) % 2)
                if not usable:
                    continue
                pcm = np.frombuffer(carry[:usable], dtype="<i2")
                carry = carry[usable:]
                out = streamer.feed(normalize_wave_minmax(pcm))
                if out.size:
                    pcm_out = np.clip(out * 32767.0, -32768, 32767).astype("<i2")
                    n_out += pcm_out.size
                    try:
                        ws.send(pcm_out.tobytes())
                    except (ConnectionClosed, OSError):  # OSError: SO_SNDTIMEO
                        return
            out = streamer.flush()
            pcm_out = np.clip(out * 32767.0, -32768, 32767).astype("<i2")
            n_out += pcm_out.size
            # counted before "done", so that a client reading /healthz after it sees it
            with state["mlock"]:
                state["requests"] += 1
            try:
                if pcm_out.size:
                    ws.send(pcm_out.tobytes())
                ws.send(json.dumps({"event": "done", "samples_out": n_out,
                                    "truncated": truncated}))
                ws.close()
            except (ConnectionClosed, OSError):
                pass
            if state["verbose"]:
                print(f"[serve] ws stream: {n_out} samples in "
                      f"{time.perf_counter() - t0:.3f}s (window {window}, overlap "
                      f"{overlap}{', truncated' if truncated else ''})", flush=True)

    return handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--g_pretrained_ckpt", required=True)
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--warm_seconds", type=float, default=2.0,
                   help="seconds of silence enhanced once before accepting traffic (and "
                        "by /admin/reload before the swap), with a streaming pass of "
                        "each power-of-two row count up to 8 (0 = off)")
    p.add_argument("--max_stream_seconds", type=float, default=3600.0,
                   help="wall-clock cap per streaming session (HTTP or WebSocket); past "
                        "it the stream is finalized and the connection closed "
                        "(0 = unlimited)")
    p.add_argument("--target_batch_seconds", type=float, default=0.0,
                   help=">0: adapt the MicroBatcher's chunk budget so that one "
                        "coalesced pass stays under this latency (0 = fixed budget)")
    p.add_argument("--no_stream_coalesce", action="store_true",
                   help="one G forward per streaming session and window, instead of "
                        "shared passes; a session's output then does not depend on the "
                        "concurrent load")
    p.add_argument("--ws_port", type=int, default=0,
                   help="also serve /enhance_stream over a WebSocket on this port "
                        "(0 = off; needs the websockets package): binary PCM16 frames in "
                        "and out, text 'end' finalizes; the same token and TLS")
    p.add_argument("--ws_ping_interval", type=float, default=20.0,
                   help="seconds between the WebSocket server's keepalive pings "
                        "(0 = no pings)")
    p.add_argument("--auth_token", default=None,
                   help="require 'Authorization: Bearer <token>' on the POST endpoints "
                        "and the WebSocket (/healthz and /metrics stay open); defaults "
                        "to $SEGAN_SERVE_TOKEN when set")
    p.add_argument("--tls_cert", default=None,
                   help="a PEM certificate chain; with --tls_key, serve HTTPS (and wss)")
    p.add_argument("--tls_key", default=None, help="the PEM private key of --tls_cert")
    p.add_argument("--tls_client_ca", default=None,
                   help="a PEM CA bundle for mutual TLS: clients must present a "
                        "certificate signed by it, on both listeners")
    p.add_argument("--drain_seconds", type=float, default=30.0,
                   help="on SIGTERM/SIGINT: stop accepting connections, wait up to this "
                        "long for requests in flight, then exit 0")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default) needs a card; cpu runs the plain PyTorch "
                        "versions of the kernels")
    p.add_argument("--verbose", action="store_true")
    return p


def parse_args(argv=None):
    """The options, with the TLS flags' pairing checked by the parser, as serve.py does."""
    p = build_parser()
    opts = p.parse_args(argv)
    if bool(opts.tls_cert) != bool(opts.tls_key):
        p.error("--tls_cert and --tls_key must be given together")
    if opts.tls_client_ca and not opts.tls_cert:
        p.error("--tls_client_ca requires --tls_cert/--tls_key")
    return opts


def tls_context(opts):
    """The listeners' server-side SSL context (None without --tls_cert); under
    --tls_client_ca a client without a certificate signed by that CA fails the
    handshake. It issues no TLS 1.3 session tickets: with them, about one mutual-TLS
    WebSocket connection in 40 lost the client's upgrade request (the listener's reader
    thread blocked with nothing to read, and the listener closed at its open timeout),
    and none did without them. The ticket is a write after the handshake, and the sync
    ``websockets`` reads and writes one SSL object from two threads."""
    if not opts.tls_cert:
        return None
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.num_tickets = 0
    ctx.load_cert_chain(opts.tls_cert, opts.tls_key)
    if opts.tls_client_ca:
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(cafile=opts.tls_client_ca)
    return ctx


def build_server(opts):
    """Load and warm the engine and bind the listeners: (server, state). The caller runs
    ``server.serve_forever()``, and ``close(server, state)`` when it returns. The
    WebSocket listener (``--ws_port``) serves on a daemon thread from here on."""
    from .models.segan import default_device

    if opts.ws_port:  # before the engine: a missing package fails at once
        try:
            from websockets.sync.server import serve as ws_serve
        except ImportError as e:
            raise ImportError("--ws_port needs the 'websockets' package, which is not "
                              "installed") from e
    device = default_device() if opts.device == "cuda" else torch.device("cpu")
    state = new_state(opts, device)
    state["gen"], seconds = build_generation(state, opts.cfg_file, opts.g_pretrained_ckpt)
    if opts.warm_seconds > 0:
        state["warm_s"] = round(seconds["warm_generate"], 3)
        print(f"[serve] warm-up done in {state['warm_s']} s", flush=True)
    srv = None
    try:  # a listener that cannot bind stops the batchers' threads again
        ctx = tls_context(opts)
        srv = ThreadingHTTPServer((opts.host, opts.port), make_handler(state))
        if ctx is not None:
            # the handshake runs on the handler thread's first read, not in accept(): a
            # client stalled mid-handshake must not block the accept loop
            srv.socket = ctx.wrap_socket(srv.socket, server_side=True,
                                         do_handshake_on_connect=False)
        state["tls"] = ctx is not None
        if opts.ws_port:
            ws_srv = ws_serve(make_ws_handler(state), opts.host, opts.ws_port, ssl=ctx,
                              ping_interval=opts.ws_ping_interval or None,
                              max_size=WS_MAX_FRAME)
            state["ws_server"] = ws_srv
            state["ws_thread"] = threading.Thread(target=ws_srv.serve_forever,
                                                  daemon=True, name="ws-server")
            state["ws_thread"].start()
    except BaseException:
        if srv is not None:
            srv.server_close()
        close_generation(state["gen"])
        raise
    return srv, state


def close(srv, state):
    """Close the listeners and stop every batcher thread: the serving generation's and
    those of the generations still waiting for retirement (retired at once)."""
    srv.server_close()
    if state.get("ws_server") is not None:
        state["ws_server"].shutdown()
        state["ws_thread"].join(timeout=10)
    state["closed"].set()
    with state["reload_lock"]:  # a reload under way publishes first, then stops
        for t in state["retiring"]:
            t.join(timeout=30)
        close_generation(state["gen"])


def main(argv=None):
    opts = parse_args(argv)
    srv, state = build_server(opts)
    inflight = state["inflight"]
    ws_srv = state.get("ws_server")

    def _graceful_stop(signum, _frame):
        state["draining"] = True
        state["signalled_at"] = time.perf_counter()
        print(f"[serve] signal {signum}: draining (up to {opts.drain_seconds:.0f}s for "
              f"requests in flight)", flush=True)
        # shutdown() waits for serve_forever to return, and this handler runs on the
        # main thread, inside serve_forever
        threading.Thread(target=srv.shutdown, daemon=True).start()
        if ws_srv is not None:  # no new sessions; those in flight see "draining"
            threading.Thread(target=ws_srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful_stop)
    signal.signal(signal.SIGINT, _graceful_stop)
    host, port = srv.server_address[:2]
    tls = state["tls"]
    if ws_srv is not None:
        print(f"[serve] websocket streaming on {'wss' if tls else 'ws'}://{host}:"
              f"{opts.ws_port}/enhance_stream (ping every {opts.ws_ping_interval:g}s)",
              flush=True)
    print(f"[serve] listening on {'https' if tls else 'http'}://{host}:{port} (slice_size "
          f"{state['gen'][0].slice_size}{', auth required' if state['auth_token'] else ''})",
          flush=True)
    srv.serve_forever()
    # close the listening socket now, so that new clients are refused at once instead
    # of waiting in the backlog through the drain; established connections go on
    srv.socket.close()
    # a grace for requests accepted before the signal but not yet counted, then wait
    # for the ones in flight (WebSocket sessions count too, and end at "draining");
    # handler threads are daemons, so the exit reaps whatever misses the deadline
    deadline = time.time() + max(0.0, opts.drain_seconds)
    time.sleep(min(1.0, max(0.0, opts.drain_seconds)))
    while inflight.count() > 0 and time.time() < deadline:
        time.sleep(0.05)
    n = inflight.count()
    t_close = time.perf_counter()
    close(srv, state)
    t_end = time.perf_counter()
    since = t_end - state.get("signalled_at", t_close)
    print(f"[serve] shutdown complete {since:.2f} s after the signal (closing "
          f"{t_end - t_close:.2f} s)"
          f"{f' ({n} request(s) abandoned at the drain deadline)' if n else ''}", flush=True)


if __name__ == "__main__":
    main()
