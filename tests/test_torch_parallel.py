"""The port's multi-GPU layer against the JAX package's on the CPU: the grid's checks
against ``make_mesh``'s, the loader's data shards against the JAX loader's batches bit
for bit, ``enhance_sharded`` over 8 CPU devices against the JAX one on a mesh of 8
virtual devices, and the SEGAN+ step at dp 2 x mp 2 (four gloo processes,
``tests/torch_dist_workers.py``) against the JAX engine at dp 2, mp 2 with the JAX draws
passed in, at the toy config and tolerances of ``tests/test_torch_train.py``. The same
group resumes from a one-process checkpoint and saves one that a one-process engine
resumes bit for bit."""

import numpy as np
import pytest
import torch

import jax

from segan_pytorch_tpu.data import DataLoader as JaxLoader
from segan_pytorch_tpu.models.segan import SEGAN as JaxSEGAN
from segan_pytorch_tpu.parallel import enhance_sharded as jax_enhance_sharded
from segan_pytorch_tpu.parallel import make_mesh
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.data.loader import DataLoader
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.parallel.inference import enhance_sharded
from segan_pytorch_tpu_torch.parallel.mesh import make_grid
from segan_pytorch_tpu_torch.parallel.sharding import Axis, shard_head
from segan_pytorch_tpu_torch.utils.checkpoint import Saver, generator_state_from_jax
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_data import KEYS, _datasets, corpus  # noqa: F401  (a fixture)
from test_torch_discriminator import randomize, record_phase
from test_torch_train import (BIAS_BEFORE_BN, L1, STEP_TOL, TOY, TRAJ_TOL, _rel,
                              port_state)
from torch_dist_workers import run_group, train_steps

B, STEPS = 4, 3


# -- the grid ---------------------------------------------------------------------------
GRID_CASES = {
    # (make_mesh arguments over 8 devices, the exception both raise or None)
    "axis names read as mp": (((4, ("data",)), {}), TypeError),
    "axis names fixed under mp": (((2, 2), {"axis_names": ("batch",)}), ValueError),
    "mp does not divide the count": (((None, 3), {}), ValueError),
    "dp x mp over the count": (((4, 4), {}), ValueError),
    "dp over the count": (((16,), {}), ValueError),
    "dp from the count over mp": (((None, 2), {}), None),
    "dp from the count": (((None,), {}), None),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_grid_checks_like_make_mesh(case):
    (args, kw), exc = GRID_CASES[case]
    if exc is not None:
        with pytest.raises(exc):
            make_mesh(*args, **kw)
        with pytest.raises(exc):
            make_grid(*args, world=8, **kw)
        return
    mesh, grid = make_mesh(*args, **kw), make_grid(*args, world=8, **kw)
    assert (grid.dp, grid.mp) == (mesh.shape["data"], mesh.shape.get("model", 1))
    assert (grid.dp_index, grid.mp_index, grid.rank) == (0, 0, 0)


def test_grid_takes_every_process():
    """One process drives one card: a grid of fewer processes than the group raises
    (make_mesh takes the first devices), and rank d * mp + m holds shard d of the data,
    m of the model."""
    with pytest.raises(ValueError, match="one process per card"):
        make_grid(2, 2, world=8)
    grid = make_grid(2, 2, world=4)
    assert grid.rows(3) == slice(0, 3)


def test_head_split_must_divide():
    """D's head (256 and 128 features) over a model axis of 3 raises, as the JAX
    shard_params does (``tests/test_parallel.py::test_mp_indivisible_raises``)."""
    D = build_discriminator(SEGANConfig(**TOY))
    with pytest.raises(ValueError, match="not divisible by mp=3"):
        shard_head(D, None, Axis(None, 3, 0))
    assert D.fc[0].weight.shape == (256, 512)  # nothing split


# -- the loader's shards ----------------------------------------------------------------
@pytest.mark.parametrize("mode", ["index list", "sharded", "global"])
def test_loader_shards_equal_the_jax_shards(corpus, tmp_path, mode):  # noqa: F811
    """Two data shards of a global batch of 12 over 41 slices (a ragged tail of 5 in
    the index-list mode): each shard's batches equal the JAX loader's shard bit for
    bit, two epochs; where the JAX shards put together are one loader's batch (the
    index list, 'global'), the port's are too."""
    j, t = _datasets(corpus, tmp_path)
    kw = dict(batch_size=12, shuffle=True, num_workers=1, seed=7)
    if mode != "index list":
        kw.update(shuffle_buffer=16, shuffle_buffer_mode=mode)
    jl = [JaxLoader(j, shard_id=s, num_shards=2, **kw) for s in range(2)]
    tl = [DataLoader(t, shard_id=s, num_shards=2, **kw) for s in range(2)]
    one = DataLoader(t, **kw)
    assert [len(x) for x in tl] == [len(x) for x in jl]
    for _ in range(2):
        shards = [list(x) for x in tl]
        for s in range(2):
            want = list(jl[s])
            assert len(shards[s]) == len(want) == len(tl[s])
            for tb, jb in zip(shards[s], want):
                for k in KEYS:
                    assert np.array_equal(np.asarray(tb[k]), np.asarray(jb[k])), (s, k)
        if mode != "sharded":
            for b0, b1, whole in zip(*shards, one):
                for k in KEYS:
                    joined = (b0[k] + b1[k] if isinstance(b0[k], list)
                              else np.concatenate([b0[k], b1[k]]))
                    assert np.array_equal(np.asarray(joined), np.asarray(whole[k])), k
    if mode == "index list":
        assert list(shards[1][-1]["mask"]) == [0] * 6 and list(shards[0][-1]["mask"]) == (
            [1] * 5 + [0])


# -- enhance_sharded --------------------------------------------------------------------
@pytest.fixture(scope="module")
def enhancers(tmp_path_factory):
    """The JAX engine of tests/test_parallel.py's small_segan with randomised G weights,
    and a port engine on the same weights."""
    kw = dict(slice_size=1024, genc_fmaps=[8, 16], genc_poolings=[4, 4], z_dim=16,
              denc_fmaps=[8, 16], denc_poolings=[4, 4], dpool_slen=64, batch_size=2)
    jseg = JaxSEGAN(JaxConfig(**kw, save_path=str(tmp_path_factory.mktemp("e"))))
    jseg.init_state(jax.random.PRNGKey(3), batch_size=2)
    g_flat = randomize({"params": jseg.state.g_params}, seed=4)
    jseg.state = jseg.state.replace(
        g_params=jax.device_put(unflatten_tree(g_flat)["params"]))
    cfg = SEGANConfig(**kw)
    G = build_generator(cfg)
    G.load_state_dict(generator_state_from_jax(g_flat), strict=True)
    return jseg, SEGAN(cfg, generator=G, device="cpu")


@pytest.mark.parametrize("overlap", [0.0, 0.5])
def test_enhance_sharded_equals_jax_on_eight_devices(enhancers, overlap):
    """9000 samples (9 chunks, padded to 16 rows) over 8 devices, each a G replica,
    against the JAX chunk grid sharded over 8 virtual devices, within 1e-5."""
    jseg, seg = enhancers
    rng = np.random.RandomState(1)
    wav = (rng.randn(9000) * 0.1).astype(np.float32)
    z = rng.randn(1, 64, 16).astype(np.float32)
    want = jax_enhance_sharded(jseg, wav, mesh=make_mesh(8), overlap=overlap, z=z)
    got = enhance_sharded(seg, wav, devices=["cpu"] * 8, overlap=overlap, z=z)
    one = enhance_sharded(seg, wav, overlap=overlap, z=z)
    assert got.shape == want.shape == (9000,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got, one)


# -- the SEGAN+ step at dp 2 x mp 2 ----------------------------------------------------
def batch(i):
    """Step i's global batch; the last step's last row (on data shard 1) masked out."""
    rng = np.random.RandomState(100 + i)
    clean = (rng.randn(B, 1024, 1) * 0.1).astype(np.float32)
    noisy = clean + (rng.randn(B, 1024, 1) * 0.02).astype(np.float32)
    mask = np.ones(B, np.float32)
    if i == STEPS - 1:
        mask[-1] = 0.0
    return clean, noisy, mask


def _jax_steps(seg, draws=None):
    out = []
    for i in range(STEPS):
        if draws is not None:
            draws.clear()
        metrics, genh, z = seg.train_step(*batch(i), jax.random.PRNGKey(10 + i), L1)
        jax.effects_barrier()
        out.append(dict({k: float(v) for k, v in metrics.items()}, genh=np.array(genh),
                        z=np.array(z),
                        phase=np.array(draws).reshape(3, 3, 2) if draws is not None
                        else None))
    return out


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """Three JAX steps at dp 2, mp 2 from randomised weights (the phase draws recorded
    from the same steps at dp 1: they depend on the keys alone), and the port's group
    of four on the same weights and draws: it resumes from a checkpoint that one port
    process wrote of those weights, and saves after its steps."""
    root = tmp_path_factory.mktemp("grid")
    engines = []
    for dp, mp in ((1, 1), (2, 2)):
        seg = JaxSEGAN(JaxConfig(**TOY, batch_size=B, dp=dp, mp=mp,
                                 save_path=str(root / f"j{dp}")))
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
    with pytest.MonkeyPatch.context() as mp:
        draws = record_phase(mp)
        engines[0].prepare_train(B)
        one = _jax_steps(engines[0], draws)
    engines[1].prepare_train(B)
    grid = _jax_steps(engines[1])
    st = engines[1].state
    end = port_state(flatten_tree({"params": st.g_params}),
                     flatten_tree({"params": st.d_params, **st.d_vars}))
    start = port_state(g_flat, d_flat)

    writer = SEGAN(SEGANConfig(**TOY, batch_size=B), generator=_loaded(build_generator,
                                                                      start[0]),
                   discriminator=_loaded(build_discriminator, start[1]), device="cpu")
    writer.init_train()
    writer.save(Saver(str(root / "in"), prefix="EOE_G-"),
                Saver(str(root / "in"), prefix="EOE_D-"), 1)
    spec = dict(cfg=dict(TOY, batch_size=B, dp=2, mp=2), state=None,
                resume=str(root / "in"), save=str(root / "out"),
                batches=[batch(i) for i in range(STEPS)],
                draws=[dict(z=s["z"], phase=s["phase"]) for s in one])
    group = run_group(train_steps, 4, root / "group", spec)
    return dict(one=one, grid=grid, start=start, end=end, group=group, root=root)


def _loaded(build, state):
    m = build(SEGANConfig(**TOY))
    m.load_state_dict(state, strict=True)
    return m


def test_jax_grid_draws_equal_the_single_device_draws(grid_run):
    """The keys alone make the draws: the JAX engine's z at dp 2, mp 2 is its z at dp 1,
    so the phase draws recorded at dp 1 are the grid's."""
    for a, b in zip(grid_run["one"], grid_run["grid"]):
        np.testing.assert_array_equal(a["z"], b["z"])


def test_grid_ranks_hold_their_shards(grid_run):
    """Rank d * 2 + m is data shard d, model shard m; after resuming from the
    one-process checkpoint it holds rows [128 m, 128 (m + 1)) of D's fc.0 weight, bit for
    bit, at step 0."""
    ck = torch.load(grid_run["root"] / "in" / "weights_EOE_D-Discriminator-1.ckpt",
                    weights_only=False)["state_dict"]["fc.0.weight"]
    for rank, r in enumerate(grid_run["group"]):
        d, m = rank // 2, rank % 2
        assert r["grid"] == (d, m) and r["resumed_step"] == 0
        assert torch.equal(r["fc0_part"], ck[128 * m: 128 * (m + 1)])


@pytest.mark.parametrize("step", range(STEPS))
def test_grid_step_matches_jax_grid(grid_run, step):
    """The four losses on every rank and Genh (data shards' rows put together) against
    the JAX engine at dp 2, mp 2: STEP_TOL at the first step, TRAJ_TOL after."""
    tol = STEP_TOL if step == 0 else TRAJ_TOL
    want = grid_run["grid"][step]
    for r in grid_run["group"]:
        for k in ("d_real", "d_fake", "g_adv", "g_l1"):
            assert _rel(r["metrics"][step][k], want[k]) <= tol, (step, k)
    group = grid_run["group"]
    genh = np.concatenate([group[0]["genh"][step], group[2]["genh"][step]])
    np.testing.assert_allclose(genh, want["genh"], rtol=tol, atol=tol)
    for r in group[1:]:  # the ranks of one data shard hold the same rows
        if r["grid"][0] == group[0]["grid"][0]:
            np.testing.assert_array_equal(r["genh"][step], group[0]["genh"][step])


def test_grid_updates_match_jax_grid(grid_run):
    """Each tensor's update over the three steps (p3 - p0; the running statistics
    themselves) within TRAJ_TOL of the JAX grid's in L2; every rank's whole state equal
    bit for bit. D's conv biases that feed a BatchNorm are held apart."""
    (g0, d0), (g3, d3) = grid_run["start"], grid_run["end"]
    group = grid_run["group"]
    errs = {}
    for side, start, end in (("G", g0, g3), ("D", d0, d3)):
        for name, v in group[0][side].items():
            for r in group[1:]:
                assert torch.equal(r[side][name], v), (side, name)
            if name.endswith("num_batches_tracked") or (side == "D" and
                                                        name in BIAS_BEFORE_BN):
                continue
            want = (end[name] - start[name]).double()
            got = (v - start[name]).double()
            if name.endswith(("running_mean", "running_var")):
                want, got = end[name].double(), v.double()
            errs[f"{side}.{name}"] = float((got - want).norm() / want.norm())
    bad = {k: e for k, e in errs.items() if not e <= TRAJ_TOL}
    assert not bad, bad


def test_grid_checkpoint_resumes_in_one_process_bit_for_bit(grid_run):
    """The group's checkpoint (D's head put together before the chief wrote it) resumes
    into a one-process engine: G, D and D's optimizer moments equal the group's whole
    state bit for bit."""
    r0 = grid_run["group"][0]
    seg = SEGAN(SEGANConfig(**TOY, batch_size=B), device="cpu")
    assert seg.resume(str(grid_run["root"] / "out")) == STEPS
    for side in ("G", "D"):
        sd = getattr(seg, side).state_dict()
        assert set(sd) == set(r0[side])
        for name, v in r0[side].items():
            assert torch.equal(sd[name], v), (side, name)
    params = dict(seg.D.named_parameters())
    for name, state in r0["d_opt"].items():
        for k, v in state.items():
            assert torch.equal(seg.d_opt.state[params[name]][k], v), (name, k)
