"""WSEGAN's step on a dp 2 x mp 2 grid of four gloo processes
(``tests/torch_dist_workers.py``) and AEWSEGAN's at dp 2, against one process, on the
CPU in float64 (the engine's compute dtype set by hand), at the toy width of
``tests/test_torch_train.py`` (slice 1024, fmaps 8/16/32).

WSEGAN is the case the grid has to get right: spectral norm in every layer, D's head
split over the model axis with its power iteration on the whole matrices (u and v whole
and equal on every rank), and the misaligned pair, whose permutation of the global batch
takes a row's partner from the other data shard. Three steps drawn from the engines' own
streams, a ragged last batch and 'additive' rows; losses, Genh and every tensor of the
state within 1e-9 relative. The same group holds the resume check: equal weights pass,
and one weight moved on one process makes every process raise.
"""
import numpy as np
import pytest
import torch

from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from torch_dist_workers import (build_engine, randomize_port, run_group, run_steps,
                                train_steps, whole_state)

TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], z_dim=32,
           denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4], dpool_slen=16, batch_size=8)
ENGINES = {
    "wsegan": (dict(wsegan=True, gnorm_type="snorm", dnorm_type="snorm", opt="adam",
                    misalign_pair=True), dict(dp=2, mp=2), 4),
    "aewsegan": (dict(aewsegan=True, opt="adam"), dict(dp=2), 2),
}
B, STEPS, TOL = 8, 3, 1e-9


def batches(engine):
    rng = np.random.RandomState(0)
    out = []
    for i in range(STEPS):
        clean = (rng.randn(B, 1024, 1) * 0.1).astype(np.float32)
        noisy = clean + (rng.randn(B, 1024, 1) * 0.02).astype(np.float32)
        mask = np.ones(B, np.float32)
        if i == STEPS - 1:
            mask[6:] = 0.0
        additive = (np.arange(B) % 3 == 0).astype(np.float32)
        out.append((clean, noisy, mask, additive) if engine == "wsegan"
                   else (clean, noisy, mask))
    return out


@pytest.fixture(scope="module", params=list(ENGINES))
def runs(request, tmp_path_factory):
    engine = request.param
    flags, grid, nprocs = ENGINES[engine]
    cfg = SEGANConfig(**TOY, **flags)
    G, D = build_generator(cfg), build_discriminator(cfg)
    randomize_port(G, 1)
    randomize_port(D, 2)
    spec = dict(engine=engine, cfg=dict(TOY, **flags, **grid), float64=True,
                state=(G.state_dict(), D.state_dict()), batches=batches(engine),
                checksum=True)
    group = run_group(train_steps, nprocs, tmp_path_factory.mktemp(engine), spec)
    one = build_engine(dict(spec, cfg=dict(TOY, **flags)))
    ref = run_steps(one, spec)
    ref.update(whole_state(one))
    return engine, group, ref


def test_steps_equal_one_process(runs):
    """Every step's losses on every rank and Genh (the data shards' rows put together)
    within 1e-9 of one process's."""
    engine, group, ref = runs
    for step in range(STEPS):
        for k, want in ref["metrics"][step].items():
            for r in group:
                got = r["metrics"][step][k]
                assert abs(got - want) <= TOL * max(abs(want), 1e-300), (step, k, got, want)
        shards = [r for r in group if r["grid"][1] == 0]
        genh = np.concatenate([r["genh"][step] for r in shards])
        want = ref["genh"][step]
        assert np.abs(genh - want).max() <= TOL * np.abs(want).max(), step


def test_state_equals_one_process_and_every_rank(runs):
    """After three steps every parameter and buffer of G and D (spectral norm's u and v
    among them) within 1e-9 relative of one process's in L2, and equal bit for bit on
    every rank, D's optimizer moments too."""
    engine, group, ref = runs
    bad = {}
    for side in ("G", "D"):
        for name, want in ref[side].items():
            got = group[0][side][name]
            err = float((got - want).norm() / want.norm().clamp_min(1e-300))
            if not err <= TOL:
                bad[f"{side}.{name}"] = err
            for r in group[1:]:
                assert torch.equal(r[side][name], got), (side, name)
    assert not bad, bad
    for name, state in group[0]["d_opt"].items():
        for r in group[1:]:
            for k, v in state.items():
                assert torch.equal(r["d_opt"][name][k], v), (name, k)


def test_resume_check_fails_every_process_on_other_weights(runs):
    _, group, _ = runs
    for r in group:
        passed, moved = r["checksum"]
        assert passed is None
        assert moved is not None and "parameter checksums differ" in moved
