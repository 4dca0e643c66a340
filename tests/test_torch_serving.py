"""The port's serving engines (``segan_pytorch_tpu_torch/utils/serving.py``) against the
JAX package's (``segan_pytorch_tpu/utils/serving.py``): ``MicroBatcher`` on the chunk
grid and on the WSEGAN / AEWSEGAN route, ``WindowBatcher`` and ``StreamingEnhancer``,
with the same weights and the same z, at toy width on the CPU, as
``tests/test_serving.py`` holds the JAX ones.

The JAX engine's weights go into the port through the checkpoint bridge (an exported
torch checkpoint for SEGAN, ``generator_state_from_jax`` with the 'spectral' bridge for
WSEGAN). Where a JAX call draws z from a key, the port gets that z explicitly.
"""
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.models.wsegan import WSEGAN as JaxWSEGAN
from segan_pytorch_tpu.utils import serving as jserving
from segan_pytorch_tpu.utils.checkpoint import (export_torch_generator, flatten_tree,
                                                unflatten_tree)
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.models.wsegan import AEWSEGAN, WSEGAN
from segan_pytorch_tpu_torch.ops.signal import pre_emphasize_np
from segan_pytorch_tpu_torch.parallel.inference import _bucket_pow2, chunk_grid, overlap_add
from segan_pytorch_tpu_torch.utils import serving
from segan_pytorch_tpu_torch.utils.checkpoint import generator_state_from_jax
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from segan_pytorch_tpu_torch.utils.serving import (MicroBatcher, StreamingEnhancer,
                                                   WindowBatcher)
from test_torch_wsegan_models import snorm_randomize

TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
           z_dim=32, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16)
G_TOL = 5e-5    # the toy G's output, as in test_torch_slice.py
# de-emphasis x[t] = 0.95 x[t-1] + y[t] sums up to 1/(1-0.95) = 20 G outputs
WAV_TOL = 20 * G_TOL
# the port against itself, one G pass against another of another batch composition:
# row-independent math, summed in another order by the CPU's convs
SELF_TOL = 1e-5


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """A JAX SEGAN with random G weights (slopes in U(0, 0.3)) and the port's SEGAN
    loaded from the JAX engine's exported torch checkpoint; returns (jax engine, port
    engine, checkpoint)."""
    jseg = JaxSEGAN(JaxConfig(**TOY, no_bias=True,
                              save_path=str(tmp_path_factory.mktemp("j"))))
    jseg.init_state(jax.random.PRNGKey(0), batch_size=1)
    rng = np.random.RandomState(0)
    flat = {}
    for path, v in flatten_tree(jseg.state.g_params).items():
        if path.endswith("act/weight"):
            flat[path] = rng.uniform(0, 0.3, v.shape)
        elif v.ndim == 3:
            flat[path] = rng.randn(*v.shape) / np.sqrt(v.shape[0] * v.shape[1])
        else:
            flat[path] = rng.randn(*v.shape) * 0.1 + (1.0 if "skip_k" in path else 0.0)
    params = unflatten_tree({k: np.asarray(v, np.float32) for k, v in flat.items()})
    jseg.state = jseg.state.replace(g_params=jax.device_put(params))
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "g.ckpt")
    export_torch_generator({"params": params}, ckpt)
    return jseg, port_engine(ckpt), ckpt


def port_engine(ckpt, seed=None, **kw):
    seg = SEGAN(SEGANConfig(**TOY, no_bias=True, **kw), device="cpu", seed=seed)
    seg.g_load_pretrained(ckpt)
    return seg


@pytest.fixture(scope="module")
def ws_engines():
    """A JAX WSEGAN (snorm G with biases, u and v near the top singular pairs) and the
    port's with the same G."""
    jseg = JaxWSEGAN(JaxConfig(**TOY, gnorm_type="snorm", wsegan=True,
                               save_path="/nonexistent"))
    jseg.init_state(jax.random.PRNGKey(0), batch_size=1)
    flat = snorm_randomize({"params": jseg.state.g_params, **jseg.state.g_vars}, seed=3)
    tree = unflatten_tree(flat)
    jseg.state = jseg.state.replace(g_params=tree["params"],
                                    g_vars={"spectral": tree["spectral"]})
    cfg = SEGANConfig(**TOY, gnorm_type="snorm", wsegan=True)
    G = build_generator(cfg)
    G.load_state_dict(generator_state_from_jax(flat), strict=True)
    return jseg, cfg, G


def raw_wav(n=2500, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.randn(n)).astype(np.float32)


def jax_z(jseg, key, length):
    """The z a JAX generate() draws from `key` for an input of `length` samples."""
    return np.asarray(jseg.G.sample_z(key, (1, length, 1)))


def force_pass(batcher, jobs):
    """Enqueue the jobs under the batcher's lock, so that its worker takes them in one
    pass, and wait for their answers."""
    with batcher._cv:
        batcher._queue.extend(jobs)
        batcher._cv.notify()
    for j in jobs:
        assert j.event.wait(120)
        assert j.error is None, j.error
    return [j.result for j in jobs]


def rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def test_bucket_pow2_equals_jax():
    from segan_pytorch_tpu.parallel.inference import _bucket_pow2 as jax_bucket

    for n in range(0, 300):
        assert _bucket_pow2(n) == jax_bucket(n)


@pytest.mark.parametrize("T", [1, 2, 4, 8, 15, 16, 40])
def test_reflect_pad_longer_than_the_input_equals_jax(T):
    """Fault C3: G's reflect pad of (14, 15) on fewer than 16 samples (a short window's
    deep layers) raised in torch's F.pad; the port now pads as jnp.pad does."""
    from segan_pytorch_tpu.ops.conv import reflect_pad_1d as jax_reflect_pad
    from segan_pytorch_tpu_torch.ops.conv import reflect_pad_1d

    x = np.random.RandomState(T).randn(2, 3, T).astype(np.float32)
    got = reflect_pad_1d(torch.from_numpy(x), 14, 15).numpy()
    want = np.asarray(jax_reflect_pad(jnp.asarray(x.transpose(0, 2, 1)), 14, 15))
    np.testing.assert_array_equal(got, want.transpose(0, 2, 1))


class TestMicroBatcher:
    @pytest.mark.parametrize("overlap", [0.0, 0.25])
    def test_batched_equals_jax_and_direct_generate(self, engines, overlap):
        """A forced three-request pass equals the JAX MicroBatcher's with the same
        requests and z, and each request's own generate() with its z."""
        jseg, seg, _ = engines
        wavs = [pre_emphasize_np(raw_wav(n, seed=i), 0.95)
                for i, n in enumerate((2500, 1024, 3333))]
        keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
        zs = [jax_z(jseg, k, 1024) for k in keys]
        jb = jserving.MicroBatcher(jseg)
        try:
            want = force_pass(jb, [jserving._Job(w, k, overlap) for w, k in zip(wavs, keys)])
        finally:
            jb.close()
        batcher = MicroBatcher(seg)
        try:
            got = force_pass(batcher, [serving._Job(w, z=z, overlap=overlap)
                                       for w, z in zip(wavs, zs)])
            assert batcher.batches == 1 and batcher.requests == 3  # one pass for all
        finally:
            batcher.close()
        for g, w, wav, z in zip(got, want, wavs, zs):
            assert g.shape == wav.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=WAV_TOL, atol=WAV_TOL)
            np.testing.assert_allclose(g, seg.generate(wav, z=z, overlap=overlap)[0],
                                       rtol=SELF_TOL, atol=SELF_TOL)

    def test_adaptive_budget_from_measured_latency(self, engines):
        """target_batch_seconds: the budget follows the warm-pass latency estimate,
        clamped to [min_batch_chunks, max_batch_chunks]; the first pass of a shape does
        not feed it; the drain counts rows rounded up to a power of two."""
        _, seg, _ = engines
        batcher = MicroBatcher(seg, max_batch_chunks=64, target_batch_seconds=0.5,
                               min_batch_chunks=8)
        try:
            assert batcher.effective_max_chunks == 64  # no estimate yet
            wav = pre_emphasize_np(raw_wav(2048, seed=1), 0.95)
            batcher.enhance(wav, rng=torch.Generator().manual_seed(0))
            assert batcher._sec_per_chunk is None  # the shape's first pass
            batcher.enhance(wav, rng=torch.Generator().manual_seed(1))
            assert batcher._sec_per_chunk is not None  # a warm pass, measured
            batcher._sec_per_chunk = 0.01   # 10 ms a chunk at a 0.5 s target: 50
            assert batcher.effective_max_chunks == 50
            batcher._sec_per_chunk = 10.0   # the floor
            assert batcher.effective_max_chunks == 8
            batcher._sec_per_chunk = 1e-6   # the hard cap
            assert batcher.effective_max_chunks == 64
            # at a budget of 50, a 33rd one-chunk job would round the pass up to 64
            batcher._sec_per_chunk = 0.01
            with batcher._cv:
                batcher._queue.extend(serving._Job(np.zeros(16, np.float32))
                                      for _ in range(60))
                taken = batcher._drain_locked()
                rest = len(batcher._queue)
                batcher._queue.clear()
            assert (len(taken), rest) == (32, 28)
        finally:
            batcher.close()

    def test_drain_coalesces_as_jax(self, engines):
        """The same queue of requests splits into the same passes as in JAX."""
        jseg, seg, _ = engines
        lengths = [700, 5000, 1024, 9000, 3000, 30000, 100, 2048, 4097]
        for budget in (4, 8, 16, 64):
            jb, tb = (jserving.MicroBatcher(jseg, max_batch_chunks=budget),
                      MicroBatcher(seg, max_batch_chunks=budget))
            try:
                passes = []
                for b, job in ((jb, lambda p: jserving._Job(p, None, 0.0)),
                               (tb, serving._Job)):
                    with b._cv:
                        b._queue.extend(job(np.zeros(n, np.float32)) for n in lengths)
                        split = []
                        while b._queue:
                            split.append([len(j.pwav) for j in b._drain_locked()])
                    passes.append(split)
                assert passes[0] == passes[1], budget
            finally:
                jb.close()
                tb.close()

    def test_a_pass_runs_only_the_real_rows(self, engines, monkeypatch):
        """A deliberate difference (ROADMAP C): where JAX pads a pass of three one-chunk
        requests to four rows, the port runs three, and its latency estimate is per row
        that ran."""
        _, seg, _ = engines
        rows = []
        infer = seg.infer_G

        def spy(x, z=None, ret_hid=False):
            rows.append(np.shape(x)[0])
            return infer(x, z, ret_hid)

        class Clock:  # each pass takes 3 s
            t = 0.0

            def perf_counter(self):
                self.t += 3.0
                return self.t

        monkeypatch.setattr(seg, "infer_G", spy)
        monkeypatch.setattr(serving, "time", Clock())
        batcher = MicroBatcher(seg, target_batch_seconds=1.0)
        try:
            for _ in range(2):
                force_pass(batcher, [serving._Job(raw_wav(1000, seed=i), overlap=0.0)
                                     for i in range(3)])
            assert rows == [3, 3]
            assert batcher._sec_per_chunk == pytest.approx(1.0)  # 3 s / 3 rows
        finally:
            batcher.close()

    def test_seeded_requests_draw_z_from_their_generator(self, engines):
        """rng draws the request's z row (1, T', z_dim) from that generator; without z
        or rng, the requests of a pass draw from the engine's stream in order, as
        generate() calls in that order do."""
        _, _, ckpt = engines
        served, direct = port_engine(ckpt, seed=5), port_engine(ckpt, seed=5)
        wavs = [pre_emphasize_np(raw_wav(n, seed=20 + n), 0.95) for n in (1500, 2600, 900)]
        batcher = MicroBatcher(served)
        try:
            got = force_pass(batcher, [
                serving._Job(wavs[0]),
                serving._Job(wavs[1], rng=torch.Generator().manual_seed(42)),
                serving._Job(wavs[2])])
        finally:
            batcher.close()
        z42 = direct.G.sample_z((1, 1024, 1), torch.Generator().manual_seed(42))
        want = [direct.generate(wavs[0])[0], direct.generate(wavs[1], z=z42)[0],
                direct.generate(wavs[2])[0]]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=SELF_TOL, atol=SELF_TOL)

    def test_concurrent_enhance_threads(self, engines):
        """Eight threads, two requests each, with their own seeds: every answer is its
        own request's (equal to generate() with that seed's draw), and the threads with
        one seed get one answer."""
        _, seg, _ = engines
        wav = pre_emphasize_np(raw_wav(2000, seed=4), 0.95)
        want = {s: seg.generate(wav, z=seg.G.sample_z(
            (1, 1024, 1), torch.Generator().manual_seed(s)))[0] for s in (7, 8)}
        batcher = MicroBatcher(seg)
        results = {}
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def hit(i):
                for k in range(2):
                    results[i, k] = batcher.enhance(
                        wav, rng=torch.Generator().manual_seed(7 + i % 2))

            ts = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts)
        finally:
            sys.setswitchinterval(switch)
            batcher.close()
        assert len(results) == 16 and batcher.requests == 16
        for (i, _), r in results.items():
            assert r.shape == (2000,)
            np.testing.assert_allclose(r, want[7 + i % 2], rtol=SELF_TOL, atol=SELF_TOL)

    def test_compute_copy_is_built_before_the_worker_runs(self, engines):
        """The bf16 copy of G (SEGAN._g) is made once, by the constructor, not lazily by
        whichever worker thread runs G first."""
        _, _, ckpt = engines
        seg = port_engine(ckpt, compute_dtype="bfloat16")
        assert seg._G_compute is None
        mb = MicroBatcher(seg)
        copy = seg._G_compute
        wb = WindowBatcher(seg)
        try:
            assert copy is not None and seg._G_compute is copy
            assert next(copy.parameters()).dtype == torch.bfloat16
        finally:
            mb.close()
            wb.close()


class TestMicroBatcherWSEGAN:
    def test_wsegan_route_equals_jax_and_generate_batch(self, ws_engines):
        """A WSEGAN engine behind the batcher serves its own one padded pass per
        utterance: equal to the JAX batcher's route with the same z, and to the engine's
        generate_batch; mixed seeded and unseeded requests draw in job order."""
        jseg, cfg, G = ws_engines
        wavs = [pre_emphasize_np(raw_wav(n, seed=i), 0.95)
                for i, n in enumerate((2500, 1024, 2500))]
        keys = [jax.random.PRNGKey(30 + i) for i in range(3)]
        zs = [jax_z(jseg, k, n + 1024 - n % 1024) for k, n in zip(keys, (2500, 1024, 2500))]
        jb = jserving.MicroBatcher(jseg)
        try:
            want = force_pass(jb, [jserving._Job(w, k, 0.0) for w, k in zip(wavs, keys)])
        finally:
            jb.close()
        served = WSEGAN(cfg, generator=G, device="cpu", seed=9)
        batcher = MicroBatcher(served)
        try:
            got = force_pass(batcher, [serving._Job(w, z=z) for w, z in zip(wavs, zs)])
            assert batcher.batches == 1
            rng = torch.Generator().manual_seed(4)
            mixed = force_pass(batcher, [serving._Job(wavs[0]),
                                         serving._Job(wavs[1], rng=rng),
                                         serving._Job(wavs[2])])
        finally:
            batcher.close()
        for g, w, wav in zip(got, want, wavs):
            assert g.shape == wav.shape
            assert rel(g, w) <= 1e-5
        ref = WSEGAN(cfg, generator=G, device="cpu", seed=9)
        ref.generate_batch(wavs, z=zs)  # the explicit z draw nothing from the stream
        z4 = ref.G.sample_z((1, 2048, 1), torch.Generator().manual_seed(4))
        direct = ref.generate_batch(wavs, z=[None, z4, None])
        for g, (w, _) in zip(mixed, direct):
            np.testing.assert_array_equal(g, w)

    def test_aewsegan_route_and_live_budget(self, ws_engines):
        """AEWSEGAN takes the same route (it is a WSEGAN engine), and the adaptive
        budget stays live there: a repeat of the padded lengths is measured."""
        _, cfg, G = ws_engines
        ae_cfg = SEGANConfig(**TOY, gnorm_type="snorm", aewsegan=True)
        served = AEWSEGAN(ae_cfg, generator=G, device="cpu", seed=7)
        ref = AEWSEGAN(ae_cfg, generator=G, device="cpu", seed=7)
        batcher = MicroBatcher(served, target_batch_seconds=0.5)
        try:
            w = pre_emphasize_np(raw_wav(2000, seed=3), 0.95)
            first = batcher.enhance(w)
            assert batcher._sec_per_chunk is None
            second = batcher.enhance(w)
            assert batcher._sec_per_chunk is not None
            assert batcher.effective_max_chunks >= batcher.min_batch_chunks
        finally:
            batcher.close()
        np.testing.assert_array_equal(first, ref.generate(w)[0])
        np.testing.assert_array_equal(second, ref.generate(w)[0])


class TestWindowBatcher:
    def test_coalesced_equals_jax_and_per_session(self, engines):
        """Three windows in one pass: each equals the JAX per-session forward with the
        same z, and the port's own (1, S, 1) forward; the same composition again is
        bit-equal."""
        jseg, seg, _ = engines
        wsegs = [raw_wav(1024, seed=i) for i in range(3)]
        zs = [jax_z(jseg, jax.random.PRNGKey(20 + i), 1024) for i in range(3)]
        wb = WindowBatcher(seg)
        try:
            def batch():
                return force_pass(wb, [serving._WinJob(w, torch.tensor(z))
                                       for w, z in zip(wsegs, zs)])

            got = batch()
            assert (wb.batches, wb.windows) == (1, 3)
            again = batch()
        finally:
            wb.close()
        for g, a, w, z in zip(got, again, wsegs, zs):
            out, _ = jseg._gfwd_jit()(jseg.state.g_params, jseg.state.g_vars,
                                      jnp.asarray(w.reshape(1, -1, 1)), jnp.asarray(z))
            np.testing.assert_allclose(g, np.asarray(out)[0, :, 0], rtol=G_TOL, atol=G_TOL)
            own = seg.infer_G(w.reshape(1, -1, 1), torch.tensor(z))[0, :, 0].numpy()
            np.testing.assert_allclose(g, own, rtol=SELF_TOL, atol=SELF_TOL)
            np.testing.assert_array_equal(g, a)

    def test_mixed_window_sizes_never_share_a_pass(self, engines):
        _, seg, _ = engines
        sizes = [1024, 2048, 1024, 2048]
        wb = WindowBatcher(seg)
        try:
            got = force_pass(wb, [serving._WinJob(raw_wav(s, seed=i), seg.G.sample_z(
                (1, s, 1), torch.Generator().manual_seed(i))) for i, s in enumerate(sizes)])
            assert wb.batches == 2  # one pass per window length
        finally:
            wb.close()
        assert [g.shape for g in got] == [(s,) for s in sizes]

    def test_warm_runs_each_power_of_two(self, engines, monkeypatch):
        _, seg, _ = engines
        rows = []
        infer = seg.infer_G
        monkeypatch.setattr(seg, "infer_G",
                            lambda x, z=None: rows.append(x.shape[0]) or infer(x, z))
        wb = WindowBatcher(seg)
        try:
            wb.warm(1024, max_rows=8)
        finally:
            wb.close()
        assert rows == [1, 2, 4, 8] and wb.batches == 0

    def test_streaming_sessions_through_shared_batcher(self, engines):
        """Two streams through one WindowBatcher equal their solo runs (each its own
        z), with their windows coalesced."""
        _, seg, _ = engines
        wav_a, wav_b = raw_wav(2500, seed=1), raw_wav(2500, seed=2)

        def run(wav, seed, batcher):
            st = StreamingEnhancer(seg, window=1024, overlap=0.25,
                                   rng=torch.Generator().manual_seed(seed), batcher=batcher)
            return np.concatenate([st.feed(wav[:1300]), st.feed(wav[1300:]), st.flush()])

        solo = [run(wav_a, 3, None), run(wav_b, 4, None)]
        wb = WindowBatcher(seg)
        try:
            got = [None, None]
            ts = [threading.Thread(target=lambda i=i, w=w, s=s: got.__setitem__(
                i, run(w, s, wb))) for i, (w, s) in enumerate(((wav_a, 3), (wav_b, 4)))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts)
            assert wb.windows == 6  # three windows per 2500-sample stream
        finally:
            wb.close()
        for g, s in zip(got, solo):
            np.testing.assert_allclose(g, s, rtol=SELF_TOL, atol=SELF_TOL)

    def test_batcher_engine_mismatch_rejected(self, engines):
        _, seg, ckpt = engines
        wb = WindowBatcher(port_engine(ckpt))
        try:
            with pytest.raises(ValueError, match="different engine"):
                StreamingEnhancer(seg, window=1024, batcher=wb)
        finally:
            wb.close()


def test_requests_and_streams_together(engines):
    """/enhance's batcher and the streams' batcher run G on two threads at once, under a
    short switch interval: each request and each stream gets its own answer."""
    _, seg, _ = engines
    wavs = [pre_emphasize_np(raw_wav(1500 + 700 * i, seed=50 + i), 0.95) for i in range(4)]
    streams = [raw_wav(3000, seed=60 + i) for i in range(3)]

    def z_of(seed):
        return seg.G.sample_z((1, 1024, 1), torch.Generator().manual_seed(seed))

    want_req = [seg.generate(w, z=z_of(i), overlap=0.25)[0] for i, w in enumerate(wavs)]

    def stream(wav, seed, batcher):
        st = StreamingEnhancer(seg, window=1024, overlap=0.25, z=z_of(seed), batcher=batcher)
        return np.concatenate([st.feed(wav[:777]), st.feed(wav[777:]), st.flush()])

    want_st = [stream(w, 10 + i, None) for i, w in enumerate(streams)]
    mb, wb = MicroBatcher(seg), WindowBatcher(seg)
    got = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=lambda i=i: got.__setitem__(
            ("req", i), mb.enhance(wavs[i], z=z_of(i), overlap=0.25))) for i in range(4)]
        ts += [threading.Thread(target=lambda i=i: got.__setitem__(
            ("st", i), stream(streams[i], 10 + i, wb))) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(switch)
        mb.close()
        wb.close()
    for i, w in enumerate(want_req):
        np.testing.assert_allclose(got["req", i], w, rtol=SELF_TOL, atol=SELF_TOL)
    for i, w in enumerate(want_st):
        np.testing.assert_allclose(got["st", i], w, rtol=SELF_TOL, atol=SELF_TOL)


class TestStreamingEnhancer:
    def _offline(self, seg, wav, window, overlap, z):
        """The offline chunk_grid + overlap_add path with the session's z."""
        pe = pre_emphasize_np(wav, seg.preemph)
        grid, hop, n = chunk_grid(pe, window, overlap)
        zb = torch.tensor(np.asarray(z)).reshape(1, -1, 32).expand(n, -1, -1)
        out = seg.infer_G(grid, zb).numpy()
        from segan_pytorch_tpu_torch.ops.signal import de_emphasize_np

        return de_emphasize_np(overlap_add(out, hop, len(wav)), seg.preemph)

    @pytest.mark.parametrize("window,overlap", [(1024, 0.25), (2048, 0.25), (1024, 0.0),
                                                (128, 0.25)])
    def test_streaming_equals_jax_and_offline(self, engines, window, overlap):
        """Ragged pieces: the port's stream equals the JAX StreamingEnhancer fed the
        same pieces with the same z, and the offline path. A window of 128 reaches the
        toy G's enc3 with 8 samples, fewer than its reflect pad (fault C3)."""
        jseg, seg, _ = engines
        wav = raw_wav(4500, seed=1)
        key = jax.random.PRNGKey(3)
        z = jax_z(jseg, key, window)
        jst = jserving.StreamingEnhancer(jseg, window=window, overlap=overlap, rng=key)
        st = StreamingEnhancer(seg, window=window, overlap=overlap, z=z)
        assert (st.hop, st.latency_samples) == (jst.hop, jst.latency_samples)
        got, want, pos = [], [], 0
        for sz in (1, 700, 123, 900, 10**9):
            chunk = wav[pos: pos + sz]
            pos += len(chunk)
            a, b = st.feed(chunk), jst.feed(chunk)
            assert a.shape == b.shape  # the same samples become final at each feed
            got.append(a)
            want.append(b)
        got.append(st.flush())
        want.append(jst.flush())
        got, want = np.concatenate(got), np.concatenate(want)
        assert got.shape == (4500,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=WAV_TOL, atol=WAV_TOL)
        np.testing.assert_allclose(got, self._offline(seg, wav, window, overlap, z),
                                   rtol=SELF_TOL, atol=SELF_TOL)

    def test_pre_emphasis_carried_across_feeds_as_jax(self):
        """The filter states alone, through a G that returns its input: the port's
        float32 arithmetic equals the JAX enhancer's bit for bit."""
        class Echo:
            poolings = [4, 4, 4]
            no_z = True

        class Eng:
            cfg = SEGANConfig(**TOY)
            preemph = 0.95
            G = Echo()
            device = torch.device("cpu")

            def _g(self):
                return None

            def infer_G(self, x, z=None):
                return torch.as_tensor(x)

            def _gfwd_jit(self):
                return lambda p, v, x, z: (x, None)

            state = type("S", (), {"g_params": None, "g_vars": None})

        wav = raw_wav(3000, seed=9)
        st = StreamingEnhancer(Eng(), window=1024, overlap=0.25)
        jst = jserving.StreamingEnhancer(Eng(), window=1024, overlap=0.25)
        got = np.concatenate([st.feed(wav[:1111]), st.feed(wav[1111:]), st.flush()])
        want = np.concatenate([jst.feed(wav[:1111]), jst.feed(wav[1111:]), jst.flush()])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, wav, atol=1e-5)  # pre- then de-emphasis

    def test_streaming_no_overlap_short_input(self, engines):
        """Input shorter than one window: everything comes at flush()."""
        _, seg, _ = engines
        wav = raw_wav(700, seed=2)
        z = seg.G.sample_z((1, 1024, 1), torch.Generator().manual_seed(9))
        st = StreamingEnhancer(seg, window=1024, overlap=0.0, z=z)
        a = st.feed(wav)
        assert a.size == 0  # the window is not complete yet
        got = np.concatenate([a, st.flush()])
        np.testing.assert_allclose(got, self._offline(seg, wav, 1024, 0.0, z),
                                   rtol=SELF_TOL, atol=SELF_TOL)

    def test_seed_and_default_z(self, engines):
        """rng draws the session's z; without z or rng it is drawn from cfg.seed, as the
        JAX enhancer keys it by cfg.seed."""
        _, seg, _ = engines
        a = StreamingEnhancer(seg, window=1024, rng=torch.Generator().manual_seed(5))
        b = StreamingEnhancer(seg, window=1024)
        np.testing.assert_array_equal(
            a._z, seg.G.sample_z((1, 1024, 1), torch.Generator().manual_seed(5)))
        np.testing.assert_array_equal(b._z, seg.G.sample_z(
            (1, 1024, 1), torch.Generator().manual_seed(seg.cfg.seed)))

    def test_bounded_latency_emission(self, engines):
        """Samples come out as soon as the window covering them is done, not at
        flush()."""
        _, seg, _ = engines
        st = StreamingEnhancer(seg, window=1024, overlap=0.25)
        out1 = st.feed(raw_wav(1024, seed=3))  # the first window is complete
        assert out1.size == st.hop  # final up to the next window's start
        assert st.feed(raw_wav(1024, seed=4)).size > 0

    def test_window_must_divide_pooling(self, engines):
        _, seg, _ = engines
        with pytest.raises(ValueError, match="pooling"):
            StreamingEnhancer(seg, window=1000)
        with pytest.raises(ValueError, match="overlap"):
            StreamingEnhancer(seg, overlap=0.7)
        assert StreamingEnhancer(seg, window=64).S == 64
