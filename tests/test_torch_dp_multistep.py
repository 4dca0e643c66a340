"""Several train steps per call (``train_step_multi``) under the multi-GPU grid, on the
CPU, in gloo groups of spawned processes (``tests/torch_dist_workers.py``).

The contract: a grouped call of S sub-steps on dp x mp processes computes what one
process's call computes on the global batches, as one step of the group computes one
process's step (``tests/test_torch_dp.py``, ``tests/test_torch_mp.py``):
- (a) SEGAN+ at dp 2, S = 2, two calls, in float64 at ``test_torch_dp``'s toy width and
  ragged batch (the mask's zeros on rank 1), draws from the engines' own streams: losses,
  Genh, parameters and running statistics within 1e-9 of one process's call;
- (b) WSEGAN at dp 2 x mp 2 (spectral norm, D's head split, the misaligned pair), one
  S = 2 call, within ``test_torch_mp``'s 1e-9;
- (c) against the JAX package: its SEGAN at dp 2 (two of the 8 CPU devices of
  ``tests/conftest.py``) runs ``train_step_multi`` at S = 2, and the port's two ranks,
  given its z and phase draws, agree within ``test_torch_multistep``'s tolerance;
- (d) the rule of ``--steps_per_call`` (``SEGAN._steps_per_call``) through the CLI: S is
  kept by ``--dp 2`` alone and by a group of one, and falls to 1, with JAX's message,
  for ``--num_processes 2``; the ``--dp 2`` run's checkpoints equal those of its
  ``--steps_per_call 1`` twin bit for bit;
- (e) a gloo grid on a CUDA device refuses a grouped call: the graph cannot hold gloo.
On the card the sub-steps are replays of one CUDA graph with the step's NCCL
collectives (``chip_smoke.py`` 14a); here the same body runs eagerly.
"""
import re
import subprocess

import numpy as np
import pytest
import torch

import jax

from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import write_pairs
from test_torch_discriminator import randomize, record_phase
from test_torch_dp import BIAS_BEFORE_BN as DP_BIAS_BEFORE_BN, TOY as DP_TOY
from test_torch_dp_cli import DEADLINE_S, _start
from test_torch_mp import ENGINES as MP_ENGINES, TOY as MP_TOY
from test_torch_multistep import _z_of
from test_torch_multistep_loop import _payloads, _same
from test_torch_train import BIAS_BEFORE_BN, STEP_TOL, TOY as TRAIN_TOY, port_state
from torch_dist_workers import build_engine, graph_on_gloo, multi_steps, randomize_port, \
    run_group, run_multi, whole_state

S, TOL = 2, 1e-9


def _stacked(n_calls, B, T, seed, ragged_from=None, additive=False):
    """`n_calls` calls of S global batches (clean, noisy, mask[, additive mask]), each
    stacked (S, B, ...); rows from `ragged_from` on masked out in every second batch."""
    rng = np.random.RandomState(seed)
    calls = []
    for _ in range(n_calls):
        clean = (rng.randn(S, B, T, 1) * 0.1).astype(np.float32)
        noisy = clean + (rng.randn(S, B, T, 1) * 0.02).astype(np.float32)
        mask = np.ones((S, B), np.float32)
        if ragged_from is not None:
            mask[1, ragged_from:] = 0.0
        arrays = [clean, noisy, mask]
        if additive:
            arrays.append(np.tile((np.arange(B) % 3 == 0).astype(np.float32), (S, 1)))
        calls.append(arrays)
    return calls


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


def _group_and_one(engine, flags, grid, nprocs, toy, calls, root):
    """The group's results by rank and one process's, from the same randomised weights
    and the engines' own streams of draws."""
    cfg = SEGANConfig(**toy, **flags)
    G = build_generator(cfg)
    D = build_discriminator(cfg) if engine != "aewsegan" else None
    randomize_port(G, 1)
    if D is not None:
        randomize_port(D, 2)
    spec = dict(engine=engine, cfg=dict(toy, **flags, **grid), float64=True,
                state=(G.state_dict(), D.state_dict() if D is not None else None),
                calls=[dict(stacked=c, l1=[100.0, 99.5]) for c in calls])
    group = run_group(multi_steps, nprocs, root, spec)
    one = build_engine(dict(spec, cfg=dict(toy, **flags)))
    ref = run_multi(one, spec)
    ref.update(whole_state(one))
    ref["step"] = one.step
    return group, ref


def _check_calls(group, ref, n_calls):
    """Every sub-step's losses on every rank and each call's last Genh (the data shards'
    rows put together, one model index) within TOL of one process's."""
    for c in range(n_calls):
        for k, want in ref["metrics"][c].items():
            assert len(want) == S
            for r in group:
                for i in range(S):
                    assert _rel(r["metrics"][c][k][i], want[i]) <= TOL, (c, k, i)
        shards = [r for r in group if r["grid"][1] == 0]
        genh = np.concatenate([r["genh"][c] for r in shards])
        want = ref["genh"][c]
        assert np.abs(genh - want).max() <= TOL * np.abs(want).max(), c


def _check_state(group, ref, apart=()):
    """Every tensor of G's and D's state within TOL of one process's in relative L2 (the
    names of `apart` within 1e-6), and equal bit for bit on every rank, D's optimizer
    state too."""
    bad = {}
    for side in ("G", "D"):
        for name, want in ref[side].items():
            got = group[0][side][name]
            if name.endswith("num_batches_tracked"):
                assert int(got) == int(want), name
                continue
            err = float((got - want).norm() / want.norm().clamp_min(1e-300))
            limit = 1e-6 if side == "D" and name in apart else TOL
            if not err <= limit:
                bad[f"{side}.{name}"] = err
            for r in group[1:]:
                assert torch.equal(r[side][name], got), (side, name)
    assert not bad, bad
    for name, state in group[0]["d_opt"].items():
        for r in group[1:]:
            for k, v in state.items():
                assert torch.equal(r["d_opt"][name][k], v), (name, k)


# -- (a) SEGAN+ at dp 2 ------------------------------------------------------------------
@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    calls = _stacked(2, 8, 4096, seed=0, ragged_from=5)
    return _group_and_one("segan", {}, dict(dp=2), 2, DP_TOY, calls,
                          tmp_path_factory.mktemp("dpmulti"))


def test_dp2_grouped_calls_equal_one_process(dp_run):
    """Two calls of two sub-steps at dp 2: every sub-step's losses and each call's Genh
    within 1e-9 of one process's calls on the global batches; four steps taken."""
    group, ref = dp_run
    _check_calls(group, ref, 2)
    assert ref["step"] == 2 * S and all(r["step"] == 2 * S for r in group)


def test_dp2_grouped_calls_leave_one_process_state(dp_run):
    """After the two calls G's and D's parameters and running statistics within 1e-9 of
    one process's (D's conv biases that feed a BatchNorm, and the running means that take
    them in, held apart as ``test_torch_dp`` holds them), equal on both ranks."""
    group, ref = dp_run
    _check_state(group, ref, DP_BIAS_BEFORE_BN)


# -- (b) WSEGAN at dp 2 x mp 2 ------------------------------------------------------------
def test_wsegan_dp2_mp2_grouped_call_equals_one_process(tmp_path):
    """One call of two sub-steps at dp 2 x mp 2 with the script's flags, 'additive' rows
    and a ragged batch: losses, Genh and the whole state (spectral norm's u and v, D's
    split head put together, D's Adam moments equal on every rank) within 1e-9."""
    flags, grid, nprocs = MP_ENGINES["wsegan"]
    calls = _stacked(1, 8, 1024, seed=1, ragged_from=6, additive=True)
    group, ref = _group_and_one("wsegan", flags, grid, nprocs, MP_TOY, calls, tmp_path)
    assert sorted(r["grid"] for r in group) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _check_calls(group, ref, 1)
    _check_state(group, ref)


def test_a_gloo_grid_on_cuda_refuses_the_graphed_call(tmp_path):
    """gloo's all-reduce waits on the host, so a CUDA graph of the step cannot hold it: a
    grouped call on a gloo grid whose engine stands on a CUDA device raises, naming the
    backend, on every rank, before it draws or steps; there is no eager fall-back."""
    spec = dict(cfg=dict(DP_TOY, dp=2), float64=True)
    for r in run_group(graph_on_gloo, 2, tmp_path, spec):
        assert r["message"] is not None and "gloo backend cannot be captured" in r["message"]
        assert r["untouched"]


# -- (c) against the JAX engine at dp 2 ---------------------------------------------------
def test_dp2_grouped_call_matches_jax_dp2_train_step_multi(tmp_path):
    """The JAX SEGAN at dp 2 (its batch sharded over two CPU devices) runs one
    ``train_step_multi`` of two steps; its phase draws are recorded from the same call at
    dp 1 (they depend on the keys alone: its z there equals the dp 2 one). The port's two
    ranks take that z and those draws: losses, Genh and the state after within
    STEP_TOL, as ``test_torch_multistep`` holds one process."""
    B, T = 4, 1024
    ((clean, noisy, mask),) = _stacked(1, B, T, seed=2, ragged_from=B - 1)
    engines = []
    for dp in (1, 2):
        seg = JaxSEGAN(JaxConfig(**TRAIN_TOY, batch_size=B, dp=dp,
                                 save_path=str(tmp_path / f"j{dp}")))
        seg.init_state(jax.random.PRNGKey(0), batch_size=B)
        engines.append(seg)
    st = engines[0].state
    g_flat = randomize({"params": st.g_params}, seed=1)
    d_flat = randomize({"params": st.d_params, **st.d_vars}, seed=2)
    g_tree, d_tree = unflatten_tree(g_flat), unflatten_tree(d_flat)
    for seg in engines:
        seg.state = seg.state.replace(
            g_params=jax.device_put(g_tree["params"]),
            d_params=jax.device_put(d_tree["params"]),
            d_vars=jax.device_put({"batch_stats": d_tree["batch_stats"]}))
        seg.prepare_train(B)
        seg.prepare_multi_step(S)
    rng = jax.random.PRNGKey(42)
    l1s = [100.0, 99.5]
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        _, _, _, jz1 = engines[0].train_step_multi(clean, noisy, mask, rng=rng, l1_w_s=l1s)
        jax.effects_barrier()
        phase = np.array(draws).reshape(S, 3, 3, 2)
    jms, _, jgenh, jz = engines[1].train_step_multi(clean, noisy, mask, rng=rng,
                                                    l1_w_s=l1s)
    assert engines[1].mesh is not None and engines[1].mesh.shape["data"] == 2
    z = np.stack([_z_of(engines[1].G, k, (B, T, 1), 5) for k in jax.random.split(rng, S)])
    np.testing.assert_array_equal(z[-1], np.asarray(jz))
    np.testing.assert_array_equal(np.asarray(jz1), np.asarray(jz))
    st = engines[1].state
    g_end, d_end = port_state(flatten_tree({"params": st.g_params}),
                              flatten_tree({"params": st.d_params, **st.d_vars}))
    spec = dict(cfg=dict(TRAIN_TOY, batch_size=B, dp=2), state=port_state(g_flat, d_flat),
                calls=[dict(stacked=[clean, noisy, mask], l1=l1s,
                            draws=dict(z=z, phase=phase))])
    group = run_group(multi_steps, 2, tmp_path / "group", spec)
    for r in group:
        for k in ("d_real", "d_fake", "g_adv", "g_l1"):
            for i in range(S):
                assert _rel(r["metrics"][0][k][i], float(jms[k][i])) <= STEP_TOL, (k, i)
    genh = np.concatenate([r["genh"][0] for r in group])
    np.testing.assert_allclose(genh, np.asarray(jgenh), rtol=STEP_TOL, atol=STEP_TOL)
    skip = BIAS_BEFORE_BN | {f"enc_blocks.{i}.norm.running_mean" for i in range(3)}
    for side, end in (("G", g_end), ("D", d_end)):
        bad = {}
        for name, v in group[0][side].items():
            if name.endswith("num_batches_tracked") or (side == "D" and name in skip):
                continue
            w = end[name].double()
            err = float((v.double() - w).norm() / max(float(w.norm()), 1e-30))
            if not err <= STEP_TOL:
                bad[name] = err
            assert torch.equal(group[1][side][name], v), (side, name)
        assert not bad, (side, bad)


# -- (d) the rule of --steps_per_call, through the CLI ------------------------------------
TOY_ARGS = ["--batch_size", "4", "--slice_size", "4096", "--genc_fmaps", "8", "16",
            "--genc_poolings", "4", "4", "--z_dim", "16", "--denc_fmaps", "8", "16",
            "--denc_poolings", "4", "4", "--dpool_slen", "256", "--no_bias",
            "--device", "cpu", "--save_freq", "1", "--no_train_gen", "--epoch", "1"]
ITER = re.compile(r"\(Iter (\d+)\) Batch (\d+)/(\d+) \(Epoch (\d+)\)")
MESSAGE = "[!] steps_per_call > 1 is single-process only; using 1"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Four runs, each one epoch of three batches (10 slices at batch 4) with
    --steps_per_call 2 unless named: 'dp', --dp 2 alone; 'dp_s1', the same with
    --steps_per_call 1; 'one', a group of one (--coordinator, --num_processes 1); 'two',
    two processes launched apart (--num_processes 2). Each: (exit codes, logs, save
    path)."""
    root = tmp_path_factory.mktemp("spc")
    train = write_pairs(root / "train", [12000, 10000, 9000])
    data = ["--clean_trainset", train[0], "--noisy_trainset", train[1],
            "--cache_dir", str(root / "cache")]
    from segan_pytorch_tpu_torch.data.se_dataset import SEDataset

    SEDataset(*train, 0.95, cache_dir=str(root / "cache"), slice_size=4096)
    runs = {
        "dp": [["--dp", "2", "--steps_per_call", "2"]],
        "dp_s1": [["--dp", "2", "--steps_per_call", "1"]],
        "one": [["--steps_per_call", "2", "--coordinator", f"file://{root}/rdv_one",
                 "--num_processes", "1", "--process_id", "0"]],
        "two": [["--steps_per_call", "2", "--coordinator", f"file://{root}/rdv_two",
                 "--num_processes", "2", "--process_id", str(i)] for i in range(2)],
    }
    out = {}
    # in two waves of three or four processes, so as not to starve the machine's other
    # tests
    for wave in (("dp", "one"), ("dp_s1", "two")):
        procs = {k: [_start(data + ["--save_path", str(root / k)] + a + TOY_ARGS,
                            root / f"{k}{i}.log") for i, a in enumerate(runs[k])]
                 for k in wave}
        for k, ps in procs.items():
            codes = []
            for p in ps:
                try:
                    codes.append(p.wait(timeout=DEADLINE_S))
                except subprocess.TimeoutExpired:
                    p.kill()
                    codes.append(p.wait())
            out[k] = (codes, [(root / f"{k}{i}.log").read_text() for i in range(len(ps))],
                      root / k)
    return out


def _logged(log: str):
    return [int(m[0]) for m in ITER.findall(log)]


def _kept(codes, logs):
    """S = 2 kept: two sub-steps, then the ragged tail's single step, logged at
    iterations 2 and 3 (one log point a call), on every process; no JAX message."""
    assert codes == [0] * len(codes), [log[-3000:] for log in logs]
    for log in logs:
        assert MESSAGE not in log
    its = _logged(logs[0])
    assert sorted(set(its)) == [2, 3], its
    return its


def test_dp_alone_keeps_steps_per_call(cli_runs):
    """--dp 2 --steps_per_call 2: one launcher, S kept; both ranks log the same
    iterations, and the chief's EOE checkpoints equal bit for bit those of the same run
    at --steps_per_call 1, which logs every iteration."""
    codes, logs, save = cli_runs["dp"]
    its = _kept(codes, logs)
    assert sorted(its) == [2, 2, 3, 3], its  # both ranks write to one log
    codes1, logs1, save1 = cli_runs["dp_s1"]
    assert codes1 == [0], logs1[0][-3000:]
    assert sorted(_logged(logs1[0])) == [1, 1, 2, 2, 3, 3], logs1[0][-3000:]
    a, b = _payloads(save1), _payloads(save)
    assert set(a) == set(b) and "EOE_G-checkpoints" in a and "EOE_D-checkpoints" in a
    for k in a:
        assert _same(a[k], b[k]), k


def test_group_of_one_keeps_steps_per_call(cli_runs):
    """A group of one (--coordinator with --num_processes 1) keeps S."""
    codes, logs, _ = cli_runs["one"]
    assert _kept(codes, logs) == [2, 3]


def test_processes_launched_apart_step_singly(cli_runs):
    """--num_processes 2 is JAX's multi-process launch: both processes print JAX's
    message and step singly, logging iterations 1-3 with the same losses."""
    codes, logs, _ = cli_runs["two"]
    assert codes == [0, 0], [log[-3000:] for log in logs]
    for log in logs:
        assert MESSAGE in log, log[-3000:]
        assert _logged(log) == [1, 2, 3], log[-3000:]
