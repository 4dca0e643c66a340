"""Serving soak test of the port: the counterpart of the repo's
``tools/serving_soak.py``, sustained mixed load against
``python -m segan_pytorch_tpu_torch.serve``, watching for leaks and metric regressions.

Load mix, all concurrent for --minutes (default 30):
  * a /enhance worker sending authorized single-shot requests back to back
  * a streaming worker running chunked /enhance_stream sessions back to back
  * an auth-failure worker sending wrong-bearer requests (the 401 path must not leak:
    its body is never read)
  * a periodic POST /admin/reload (a new generation built and swapped in, the old one
    retired ``serve.RETIRE_SECONDS`` later)

Every --sample_s the harness records the server's RSS, fd count and thread count
(/proc/<pid>), plus a /metrics scrape; counters are checked for monotonicity across
samples (a reload must not reset or regress them). On the card (``--device cuda``, the
default) each sample also reads the card's ``memory.used`` (nvidia-smi, the whole card,
in MiB) and the number of replaced generations not yet retired, since a generation
holds its device memory until its retirement. The server is not matched by pid through
``--query-compute-apps``: in a container those pids can be the host's. A soak shorter
than ``RETIRE_SECONDS`` holds one generation per recent reload, so the card's memory
grows with the reloads by design; whether a retired generation gives its memory back is
``tools/reload_leak_probe.py``'s verdict, not this tool's.

Verdicts in the output JSON, as the JAX tool's:
  rss_slope_kb_per_min: least-squares slope over the last 2/3 of samples (the first
    third is warm-up and arena growth); flat means no leak
  fd_drift / thread_drift: max minus the steady-state median
  metrics_monotonic: no counter ever decreased
  errors: any non-200 on authorized paths, any non-401 on the rogue path

    python -u -m segan_pytorch_tpu_torch.tools.serving_soak --g_ckpt <ckpt> \\
        --cfg_file <train.opts> --minutes 30 --out serving_soak.json [--device cpu]
"""
import argparse
import http.client
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# the directory that holds the package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOKEN = "soak-secret-token"


def make_wav_bytes(dur, sr=16000, seed=0):
    import io

    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    t = np.arange(int(dur * sr)) / sr
    x = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(t.size)
    buf = io.BytesIO()
    wavfile.write(buf, sr, (x * 32767 / max(1e-9, np.abs(x).max())).astype("<i2"))
    return buf.getvalue()


def launch(args):
    """Start the server and wait for /healthz: (base URL, process)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    log_f = open(args.log, "w")
    cmd = [sys.executable, "-m", "segan_pytorch_tpu_torch.serve",
           "--g_pretrained_ckpt", args.g_ckpt, "--cfg_file", args.cfg_file,
           "--port", str(args.port), "--warm_seconds", "0.2",
           "--auth_token", TOKEN, "--device", args.device]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log_f,
                            stderr=subprocess.STDOUT, text=True)
    log_f.close()
    base = f"http://127.0.0.1:{args.port}"
    deadline = time.time() + args.startup_timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"server died during startup; see {args.log}")
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=2) as r:
                if r.status == 200:
                    return base, proc
        except Exception:
            time.sleep(1.0)
    proc.kill()
    raise RuntimeError("server never became healthy")


def enhance(base, wav_bytes, token=TOKEN, seed=1, timeout=120):
    req = urllib.request.Request(base + f"/enhance?seed={seed}",
                                 data=wav_bytes, method="POST",
                                 headers={"Content-Type": "audio/wav",
                                          "Authorization": f"Bearer {token}"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        return r.status, len(body)


def stream_session(base, pcm, window=4096, overlap=0.25, reps=8):
    host = base.split("//")[1]
    conn = http.client.HTTPConnection(host, timeout=120)
    got = []
    done = threading.Event()

    def reader():
        try:
            resp = conn.getresponse()
            if resp.status != 200:
                got.append(("err", resp.status))
                resp.read()
                return
            while True:
                data = resp.read(1 << 16)
                if not data:
                    break
                got.append(("data", len(data)))
        finally:
            done.set()

    conn.putrequest("POST", f"/enhance_stream?seed=1&window={window}"
                            f"&overlap={overlap}")
    conn.putheader("Transfer-Encoding", "chunked")
    conn.putheader("Authorization", f"Bearer {TOKEN}")
    conn.endheaders()
    threading.Thread(target=reader, daemon=True).start()
    hop = int(window * (1.0 - overlap)) or window
    pos = 0
    pieces = [pcm[:window + hop]]
    pos = window + hop
    for _ in range(reps):
        pieces.append(pcm[pos: pos + hop])
        pos += hop
        if pos >= pcm.size:
            break
    for piece in pieces:
        b = piece.astype("<i2").tobytes()
        conn.send(f"{len(b):x}\r\n".encode() + b + b"\r\n")
        time.sleep(0.005)
    conn.send(b"0\r\n\r\n")
    ok = done.wait(timeout=120)
    conn.close()
    n_bytes = sum(n for k, n in got if k == "data")
    errs = [n for k, n in got if k == "err"]
    return ok and not errs and n_bytes > 0, n_bytes


def proc_stats(pid):
    out = {}
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                out["rss_kb"] = int(re.search(r"(\d+)", line).group(1))
            elif line.startswith("Threads:"):
                out["threads"] = int(re.search(r"(\d+)", line).group(1))
    out["fds"] = len(os.listdir(f"/proc/{pid}/fd"))
    return out


def card_memory_used_mib():
    """The card's memory.used in MiB, as nvidia-smi reads it for the whole card (the
    first card that CUDA_VISIBLE_DEVICES names, else card 0)."""
    card = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    out = subprocess.run(["nvidia-smi", f"--id={card}", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=30, check=True).stdout
    return int(out.split()[0])


def scrape_metrics(base):
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    vals = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            parts = line.rsplit(None, 1)
            if len(parts) == 2:
                try:
                    vals[parts[0]] = float(parts[1])
                except ValueError:
                    pass
    return vals


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--g_ckpt", required=True)
    ap.add_argument("--cfg_file", required=True)
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--sample_s", type=float, default=15.0)
    ap.add_argument("--reload_s", type=float, default=60.0)
    ap.add_argument("--port", type=int, default=8139)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the server's device (Def: cuda, which needs a card)")
    ap.add_argument("--startup_timeout", type=float, default=180,
                    help="seconds for the server to answer /healthz: torch's import, "
                         "the kernels' build when not cached, G's load and warm-up")
    ap.add_argument("--log", default=os.path.join(tempfile.gettempdir(),
                                                  "serving_soak_server.log"))
    ap.add_argument("--out", default="serving_soak.json")
    return ap


def main(argv=None) -> dict:
    """Run the soak; writes the report to --out and returns it."""
    args = build_parser().parse_args(argv)
    # the server runs from the package's directory
    args.g_ckpt, args.cfg_file = os.path.abspath(args.g_ckpt), os.path.abspath(args.cfg_file)
    from ..serve import RETIRE_SECONDS

    on_card = args.device == "cuda"
    base, proc = launch(args)
    print(f"[soak] server up pid={proc.pid} at {base}", flush=True)
    stop = threading.Event()
    counts = {"enhance_ok": 0, "enhance_err": 0, "stream_ok": 0,
              "stream_err": 0, "auth401": 0, "auth_other": 0, "reloads": 0,
              "reload_err": 0}
    reloaded_at = []  # time.time() of each reload answered 200
    lock = threading.Lock()
    wav = make_wav_bytes(1.0, seed=3)
    pcm = (np.frombuffer(wav[44:], dtype="<i2")).astype(np.int16)

    def w_enhance():
        seed = 0
        while not stop.is_set():
            seed += 1
            try:
                st, n = enhance(base, wav, seed=seed)
                with lock:
                    counts["enhance_ok" if st == 200 and n > 0
                           else "enhance_err"] += 1
            except Exception:
                with lock:
                    counts["enhance_err"] += 1
            time.sleep(0.05)

    def w_stream():
        while not stop.is_set():
            try:
                ok, _ = stream_session(base, pcm)
                with lock:
                    counts["stream_ok" if ok else "stream_err"] += 1
            except Exception:
                with lock:
                    counts["stream_err"] += 1
            time.sleep(0.1)

    def w_auth():
        while not stop.is_set():
            try:
                enhance(base, wav, token="wrong-token")
                with lock:
                    counts["auth_other"] += 1  # should never 200
            except urllib.error.HTTPError as e:
                with lock:
                    counts["auth401" if e.code == 401 else "auth_other"] += 1
            except Exception:
                with lock:
                    counts["auth_other"] += 1
            time.sleep(0.5)

    def w_reload():
        while not stop.wait(args.reload_s):
            body = json.dumps({"g_ckpt": args.g_ckpt}).encode()
            req = urllib.request.Request(
                base + "/admin/reload", data=body, method="POST",
                headers={"Content-Type": "application/json",
                         "Authorization": f"Bearer {TOKEN}"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    with lock:
                        counts["reloads" if r.status == 200
                               else "reload_err"] += 1
                        if r.status == 200:
                            reloaded_at.append(time.time())
            except Exception:
                with lock:
                    counts["reload_err"] += 1

    workers = [threading.Thread(target=f, daemon=True)
               for f in (w_enhance, w_stream, w_auth, w_reload)]
    for w in workers:
        w.start()

    samples = []
    mono_violations = []
    prev_metrics = {}
    t_end = time.time() + args.minutes * 60
    while time.time() < t_end:
        time.sleep(args.sample_s)
        now = time.time()
        s = {"t": round(now, 1), **proc_stats(proc.pid)}
        if on_card:
            s["card_memory_used_mib"] = card_memory_used_mib()
            with lock:  # replaced generations that still hold their memory
                s["generations_unretired"] = sum(now - t < RETIRE_SECONDS
                                                 for t in reloaded_at)
        try:
            m = scrape_metrics(base)
            for k, v in prev_metrics.items():
                if ("total" in k or "count" in k) and m.get(k, v) < v:
                    mono_violations.append({"t": s["t"], "key": k,
                                            "prev": v, "now": m.get(k)})
            prev_metrics = m
            s["metrics"] = {k: v for k, v in m.items()
                            if "total" in k or "count" in k or "inflight" in k}
        except Exception as e:
            s["metrics_error"] = str(e)
        with lock:
            s["counts"] = dict(counts)
        samples.append(s)
        card = (f" card={s['card_memory_used_mib']}MiB "
                f"unretired={s['generations_unretired']}" if on_card else "")
        print(f"[soak] {s['t']} rss={s['rss_kb']}KB fds={s['fds']} "
              f"thr={s['threads']}{card} {s['counts']}", flush=True)
    stop.set()
    for w in workers:
        w.join(timeout=150)

    # verdicts
    rss = np.array([s["rss_kb"] for s in samples], float)
    ts = np.array([s["t"] for s in samples], float)

    def slope_over(frac):
        """Least-squares RSS slope (kB/min) over the trailing `frac` of
        samples. Reported over three shrinking windows because glibc arenas
        grow toward the peak live set (≈ reload_s/150 s overlapping engine
        generations) and never return pages — a leak keeps ALL windows at the
        same positive slope, arena warmup decays toward zero in the later
        windows. Object/buffer-level ground truth lives in
        tools/reload_leak_probe.py (weak references and memory_allocated per
        retired generation)."""
        tail = slice(len(rss) - int(len(rss) * frac), None)
        if len(rss[tail]) < 3:
            return float("nan")
        return float(np.polyfit(ts[tail] / 60.0, rss[tail], 1)[0])

    fds = [s["fds"] for s in samples]
    thr = [s["threads"] for s in samples]
    report = {
        "duration_min": args.minutes,
        "samples": samples,
        "counts": counts,
        "verdicts": {
            "rss_slope_kb_per_min": round(slope_over(2 / 3), 2),
            "rss_slope_last_third": round(slope_over(1 / 3), 2),
            "rss_slope_last_quarter": round(slope_over(1 / 4), 2),
            "rss_first_last_kb": [int(rss[0]), int(rss[-1])],
            "fd_drift": int(max(fds) - int(np.median(fds[len(fds) // 3:]))),
            "thread_drift": int(max(thr) - int(np.median(thr[len(thr) // 3:]))),
            "metrics_monotonic": not mono_violations,
            "mono_violations": mono_violations[:20],
            "errors": {k: counts[k] for k in
                       ("enhance_err", "stream_err", "auth_other",
                        "reload_err")},
        },
    }
    proc.terminate()
    proc.wait(timeout=60)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("[soak] verdicts:", json.dumps(report["verdicts"]), flush=True)
    return report


if __name__ == "__main__":
    main()
