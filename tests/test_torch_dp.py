"""Data-parallel training of the port on the CPU: gloo groups of spawned processes
(``tests/torch_dist_workers.py``) at toy width (slice 4096, fmaps 8/16 in G and D).

The contract: dp processes compute, at every step, what one process computes on the
global batch. Held in float64 (the engine's compute dtype set by hand), where the only
differences left are sums taken in another order: three SEGAN+ steps at dp 2 on a
ragged batch whose mask zeros all sit on rank 1, drawn from the engines' own streams,
against one process within 1e-9 relative (losses, Genh, parameters, running
statistics); D's conv biases that feed a BatchNorm are held apart, as
``tests/test_torch_train.py`` holds them. The same group scores a validation set with
the sharded ``evaluate``. A process that fails makes its group fail, and no process is
left waiting.
"""

import numpy as np
import pytest
import torch

from segan_pytorch_tpu_torch.data.se_dataset import SEDataset
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.parallel import mesh
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import write_pairs
from torch_dist_workers import (build_engine, fail_on_rank_1, randomize_port, run_group,
                                run_steps, train_steps, whole_state)

TOY = dict(slice_size=4096, genc_fmaps=[8, 16], genc_poolings=[4, 4], z_dim=16,
           denc_fmaps=[8, 16], denc_poolings=[4, 4], dpool_slen=256, no_bias=True,
           batch_size=8, eval_workers=1)
B, STEPS, TOL = 8, 3, 1e-9
# D's conv biases feed a BatchNorm, which takes the per-channel mean out: their true
# gradient is 0 and RMSprop turns its rounding noise into lr-size steps; they and the
# running means that take them in are held apart (checked to stay within 1e-6)
BIAS_BEFORE_BN = {f"enc_blocks.{i}.{leaf}" for i in range(2)
                  for leaf in ("conv.bias", "norm.running_mean")}


def batches():
    """Three global batches of 8; the mask's zeros (rows 5-7) all fall on rank 1."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        clean = (rng.randn(B, 4096, 1) * 0.1).astype(np.float32)
        noisy = clean + (rng.randn(B, 4096, 1) * 0.02).astype(np.float32)
        mask = np.ones(B, np.float32)
        mask[5:] = 0.0
        out.append((clean, noisy, mask))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dp 2 group's results by rank, and one process's on the same global batches,
    from the same randomised weights; both score the validation set first."""
    root = tmp_path_factory.mktemp("dp")
    valid = write_pairs(root / "valid", [8192, 8000, 6000], seed=1)
    cache = str(root / "cache")
    SEDataset(*valid, 0.95, cache_dir=cache, slice_size=4096, slice_workers=1)
    cfg = SEGANConfig(**TOY)
    G, D = build_generator(cfg), build_discriminator(cfg)
    randomize_port(G, 1)
    randomize_port(D, 2)
    spec = dict(cfg=dict(TOY, dp=2, save_path=str(root / "ck")),
                state=(G.state_dict(), D.state_dict()), float64=True, batches=batches(),
                eval_dirs=valid, eval_cache=cache)
    group = run_group(train_steps, 2, root / "group", spec)
    one = build_engine(dict(spec, cfg=dict(TOY, save_path=str(root / "one"))))
    ref = {"evaluate": one.evaluate(one.cfg, _valid_loader(valid, cache), 100,
                                    do_noisy=True)}
    one.close_pool()
    ref.update(run_steps(one, spec))
    ref.update(whole_state(one))
    return group, ref


def _valid_loader(dirs, cache):
    from segan_pytorch_tpu_torch.data.loader import DataLoader

    ds = SEDataset(*dirs, 0.95, cache_dir=cache, slice_size=4096, slice_workers=1)
    return DataLoader(ds, batch_size=300, shuffle=False, num_workers=1, seed=5)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


@pytest.mark.parametrize("step", range(STEPS))
def test_dp2_step_equals_one_process(runs, step):
    """Each step's four losses (the global batch's, on every rank) and Genh (the ranks'
    rows put together) equal one process's within 1e-9."""
    group, ref = runs
    for k, want in ref["metrics"][step].items():
        for r in group:
            assert _rel(r["metrics"][step][k], want) <= TOL, (step, k, r["metrics"][step][k],
                                                               want)
    genh = np.concatenate([r["genh"][step] for r in group])
    want = ref["genh"][step]
    assert np.abs(genh - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("side", ["G", "D"])
def test_dp2_parameters_and_running_statistics_equal_one_process(runs, side):
    """After three steps every tensor of G's and D's state (parameters, BatchNorm running
    statistics) within 1e-9 relative of one process's, in L2."""
    group, ref = runs
    errs = {}
    for name, want in ref[side].items():
        if name.endswith("num_batches_tracked"):
            assert int(group[0][side][name]) == int(want) == STEPS * 3, name
            continue
        got = group[0][side][name]
        err = float((got - want).norm() / want.norm().clamp_min(1e-300))
        limit = 1e-6 if side == "D" and name in BIAS_BEFORE_BN else TOL
        errs[name] = (err, limit)
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    assert not bad, bad


def test_every_rank_holds_the_same_state(runs):
    """Global statistics, summed gradients and the same optimizer steps leave the two
    ranks' parameters, buffers and D's optimizer state equal bit for bit."""
    group, _ = runs
    for side in ("G", "D"):
        for name, v in group[0][side].items():
            assert torch.equal(v, group[1][side][name]), (side, name)
    for name, state in group[0]["d_opt"].items():
        for k, v in state.items():
            assert torch.equal(v, group[1]["d_opt"][name][k]), (name, k)


def test_sharded_evaluate_returns_one_process_lists_on_every_rank(runs):
    """Each rank scores its share of the rows; after the exchange both return the lists
    one process returns, in its order."""
    group, ref = runs
    want_e, want_n = ref["evaluate"]
    assert len(want_e["pesq"]) == 6  # the slices of three utterances
    for r in group:
        got_e, got_n = r["evaluate"]
        assert got_e == want_e and got_n == want_n


def test_a_failed_process_fails_the_group_and_none_is_left_waiting(tmp_path):
    """Rank 1 raises before a collective that rank 0 waits in: the group fails within
    its deadline, with rank 1's traceback, and no process is left alive."""
    with pytest.raises(AssertionError, match="rank 1 fails"):
        run_group(fail_on_rank_1, 2, tmp_path, {}, timeout=90)


def test_num_processes_without_a_coordinator_raises():
    with pytest.raises(ValueError, match="--coordinator"):
        mesh.initialize_distributed(None, 2, 0, "cpu")
    with pytest.raises(ValueError, match="--process_id"):
        mesh.initialize_distributed("file:///nowhere", 2, 2, "cpu")
    # one process without a coordinator joins nothing
    assert mesh.initialize_distributed(None, 1, 0, "cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
