"""Measure the port's serving surface end to end over live HTTP: the counterpart of
the repo's ``tools/serving_bench.py``. /enhance request latency, concurrent-request
coalescing (the MicroBatcher), and /enhance_stream bounded-latency streaming
(time-to-first-audio and the steady-state cadence, alone and with concurrent sessions
sharing window passes through the WindowBatcher).

It starts ``python -m segan_pytorch_tpu_torch.serve --device <device>`` on the given
checkpoint, waits for /healthz, drives it, prints ONE JSON line (the JAX tool's keys),
and stops the server.

    python -m segan_pytorch_tpu_torch.tools.serving_bench --g_ckpt <ckpt> \
        --cfg_file <train.opts> [--dur 2.0] [--reps 12] [--concurrency 8] \
        [--window 4096] [--device cpu]

The server runs on the CUDA card unless ``--device cpu`` is given (without a card it
fails at start-up, and the tool with it). Its log goes to ``--log`` (by default a file
in the temp directory).
"""
import argparse
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
from scipy.io import wavfile

# the directory that holds the package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_wav_bytes(dur, sr=16000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(dur * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
         + 0.05 * rng.randn(t.size))
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    buf = io.BytesIO()
    wavfile.write(buf, sr, pcm)
    return buf.getvalue(), pcm


def launch(args):
    """Start the server and wait for /healthz: (base URL, process)."""
    # APPEND to PYTHONPATH: clobbering it would drop entries the deployment relies on
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    log_f = open(args.log, "w")
    cmd = [sys.executable, "-m", "segan_pytorch_tpu_torch.serve",
           "--g_pretrained_ckpt", args.g_ckpt, "--cfg_file", args.cfg_file,
           "--port", str(args.port), "--warm_seconds", str(args.warm_seconds),
           "--device", args.device]
    if args.no_stream_coalesce:
        cmd.append("--no_stream_coalesce")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log_f,
                            stderr=subprocess.STDOUT, text=True)
    log_f.close()
    base = f"http://127.0.0.1:{args.port}"
    deadline = time.time() + args.startup_timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"server died; see {args.log}")
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=2) as r:
                if r.status == 200:
                    return base, proc
        except Exception:
            time.sleep(1.0)
    proc.kill()
    raise RuntimeError("server never became healthy")


def enhance_once(base, wav_bytes, seed=1, timeout=600):
    req = urllib.request.Request(base + f"/enhance?seed={seed}",
                                 data=wav_bytes,
                                 headers={"Content-Type": "audio/wav"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        assert r.status == 200, body[:200]
    return (time.perf_counter() - t0) * 1e3


def bench_enhance(base, wav_bytes, reps):
    enhance_once(base, wav_bytes)  # warm the exact shape
    lat = [enhance_once(base, wav_bytes) for _ in range(reps)]
    return lat


def healthz(base):
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        return json.loads(r.read())


def bench_concurrent(base, wav_bytes, n):
    lat = [None] * n
    barrier = threading.Barrier(n + 1)

    def worker(i):
        barrier.wait()
        lat[i] = enhance_once(base, wav_bytes, seed=1)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = (time.perf_counter() - t0) * 1e3
    return wall, lat


def bench_stream(base, pcm, window, overlap, reps_windows):
    """Feed window-sized PCM16 pieces as chunked transfer; a reader thread
    timestamps response-body arrivals. Returns (first_audio_ms, per-window
    arrival lags ms)."""
    host = base.split("//")[1]
    conn = http.client.HTTPConnection(host, timeout=600)
    arrivals = []          # (t, n_bytes)
    send_times = []        # t when each input window finished sending
    done = threading.Event()

    def reader():
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()[:300]
        while True:
            data = resp.read1(1 << 20) if hasattr(resp, "read1") else resp.read(4096)
            if not data:
                break
            arrivals.append((time.perf_counter(), len(data)))
        done.set()

    conn.putrequest("POST", f"/enhance_stream?seed=1&window={window}"
                            f"&overlap={overlap}")
    conn.putheader("Transfer-Encoding", "chunked")
    conn.endheaders()
    rd = threading.Thread(target=reader, daemon=True)
    rd.start()
    hop = int(window * (1.0 - overlap)) or window
    # Prime: the first output needs window + hop input samples worst-case.
    n_prime = window + hop
    pieces = [pcm[:n_prime]]
    pos = n_prime
    for _ in range(reps_windows):
        pieces.append(pcm[pos: pos + hop])
        pos += hop
        if pos >= pcm.size:
            break
    for piece in pieces:
        b = piece.astype("<i2").tobytes()
        conn.send(f"{len(b):x}\r\n".encode() + b + b"\r\n")
        send_times.append(time.perf_counter())
        # wait for the server to catch up before the next window arrives, as a
        # real-time microphone would pace it; lag is measured per send below
        time.sleep(0.005)
    conn.send(b"0\r\n\r\n")
    done.wait(timeout=600)
    conn.close()
    if not arrivals:
        raise RuntimeError("no streamed audio arrived")
    first_audio_ms = (arrivals[0][0] - send_times[0]) * 1e3
    # steady state: for each subsequent send, the lag until the next arrival
    lags = []
    for st in send_times[1:]:
        nxt = [t for (t, _) in arrivals if t >= st]
        if nxt:
            lags.append((nxt[0] - st) * 1e3)
    return first_audio_ms, lags


def bench_concurrent_streams(base, pcm, window, overlap, n, reps_windows):
    """N concurrent streaming sessions fed in (approximate) lockstep; returns
    (per-session lag lists, wall ms). Combined with the healthz win_batches
    delta this shows whether concurrent hops share device passes (the
    WindowBatcher) instead of serializing N forwards per hop."""
    barrier = threading.Barrier(n + 1)
    results = [None] * n

    def worker(i):
        barrier.wait()
        results[i] = bench_stream(base, pcm, window, overlap, reps_windows)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = (time.perf_counter() - t0) * 1e3
    return results, wall


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--g_ckpt", required=True)
    ap.add_argument("--cfg_file", required=True)
    ap.add_argument("--port", type=int, default=29901)
    ap.add_argument("--dur", type=float, default=2.0)
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--overlap", type=float, default=0.25)
    ap.add_argument("--stream_windows", type=int, default=16)
    ap.add_argument("--stream_concurrency", type=int, default=4,
                    help="concurrent streaming sessions for the shared-pass "
                         "(WindowBatcher) measurement; 0 disables")
    ap.add_argument("--no_stream_coalesce", action="store_true",
                    help="launch the server with per-session window forwards "
                         "(A/B baseline for the coalescing measurement)")
    ap.add_argument("--warm_seconds", type=float, default=2.0)
    ap.add_argument("--startup_timeout", type=float, default=180,
                    help="seconds for the server to answer /healthz: torch's import, "
                         "the kernels' build when not cached, G's load and warm-up")
    ap.add_argument("--log", default=os.path.join(tempfile.gettempdir(),
                                                  "serving_bench_server.log"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the server's device (Def: cuda, which needs a card)")
    return ap


def main(argv=None) -> dict:
    """Run the benchmark; prints and returns its JSON line's object."""
    args = build_parser().parse_args(argv)
    # the server runs from the package's directory
    args.g_ckpt, args.cfg_file = os.path.abspath(args.g_ckpt), os.path.abspath(args.cfg_file)

    wav_bytes, _ = make_wav_bytes(args.dur)
    stream_dur = max(args.dur,
                     (args.window * (2 + args.stream_windows)) / 16000 + 1)
    _, pcm_long = make_wav_bytes(stream_dur, seed=1)

    base, proc = launch(args)
    try:
        lat = bench_enhance(base, wav_bytes, args.reps)
        p50 = statistics.median(lat)
        p90 = sorted(lat)[int(0.9 * (len(lat) - 1))]
        bench_concurrent(base, wav_bytes, args.concurrency)  # warm batched shapes
        h0 = healthz(base)
        wall, conc_lat = bench_concurrent(base, wav_bytes, args.concurrency)
        h1 = healthz(base)
        passes = h1["batches"] - h0["batches"]
        bench_stream(base, pcm_long, args.window, args.overlap, 2)  # warm stream shapes
        first_ms, lags = bench_stream(base, pcm_long, args.window,
                                      args.overlap, args.stream_windows)
        conc_stream = {}
        if args.stream_concurrency > 1:
            # warm the coalesced row-bucket shapes, then measure
            bench_concurrent_streams(base, pcm_long, args.window,
                                     args.overlap, args.stream_concurrency, 2)
            hs0 = healthz(base)
            sres, swall = bench_concurrent_streams(
                base, pcm_long, args.window, args.overlap,
                args.stream_concurrency, args.stream_windows)
            hs1 = healthz(base)
            win_passes = hs1.get("win_batches", 0) - hs0.get("win_batches", 0)
            win_windows = hs1.get("win_windows", 0) - hs0.get("win_windows", 0)
            all_lags = [v for (_, ls) in sres for v in ls]
            conc_stream = {
                "stream_concurrency": args.stream_concurrency,
                "stream_conc_window_passes": win_passes,
                "stream_conc_windows": win_windows,
                # >1 means concurrent hops shared device passes
                "stream_windows_per_pass": (round(win_windows / win_passes, 2)
                                            if win_passes else None),
                "stream_conc_lag_p50_ms": (round(statistics.median(all_lags), 1)
                                           if all_lags else None),
                "stream_conc_wall_ms": round(swall, 1),
            }
        out = {
            "metric": "serving_latency",
            "utt_seconds": args.dur,
            "enhance_p50_ms": round(p50, 1),
            "enhance_p90_ms": round(p90, 1),
            "enhance_rtf": round(p50 / (args.dur * 1e3), 4),
            "concurrency": args.concurrency,
            "concurrent_wall_ms": round(wall, 1),
            "concurrent_device_passes": passes,
            "coalesce_speedup": round(args.concurrency * p50 / wall, 2),
            "stream_window": args.window,
            "stream_overlap": args.overlap,
            "stream_first_audio_ms": round(first_ms, 1),
            "stream_lag_p50_ms": round(statistics.median(lags), 1) if lags else None,
            "stream_lag_p90_ms": (round(sorted(lags)[int(0.9 * (len(lags) - 1))], 1)
                                  if lags else None),
            **conc_stream,
        }
        print(json.dumps(out), flush=True)
        return out
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except Exception:
            proc.kill()


if __name__ == "__main__":
    main()
