"""Spectral norm in the port (``models/modules.py``: the state names of torch's legacy
``spectral_norm``, JAX's power iteration) against the JAX package's
``spectral_normalize``, layer by layer and in whole snorm G and D at toy width
(``test_torch_wsegan_bridge.py`` holds the checkpoint bridge and the power spectrum).

Weights, u and v are drawn with numpy seeds and carried across by the bridge; inputs too.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models import discriminator as jdisc
from segan_pytorch_tpu.models import modules as jmod
from segan_pytorch_tpu.models.generator import build_generator as jax_build_g
from segan_pytorch_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models import modules as tmod
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.utils.checkpoint import (discriminator_state_from_jax,
                                                      generator_state_from_jax)
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_discriminator import randomize, record_phase

LAYER_TOL = 1e-6  # one layer in fp32: its output, u and v after one power iteration
MODEL_TOL = 1e-5  # a whole G or D in fp32
KEY = jax.random.PRNGKey(0)
G_TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
             z_dim=32, gnorm_type="snorm")
D_TOY = dict(slice_size=1024, gkwidth=31, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4],
             dpool_slen=16, dnorm_type="snorm")
HEADS = ["none", "conv", "gmax", "gavg", "mlp"]


def jax_snorm_matrix(module_path: str, w: np.ndarray) -> np.ndarray:
    """The (rows, cols) view of a JAX weight that its spectral norm takes: a conv's (K,
    Cin, Cout) as (Cout, K Cin), a deconv's as (Cout, Cin K), a Linear's (in, out) as
    (out, in), a PReLU slope (C,) as (C, 1)."""
    if w.ndim == 3 and module_path.endswith("deconv"):
        return w.transpose(2, 1, 0).reshape(w.shape[2], -1)
    if w.ndim == 3:
        return w.reshape(-1, w.shape[-1]).T
    return w.T if w.ndim == 2 else w[:, None]


def near_top_pair(mat: np.ndarray, rng, iters: int = 2):
    """(u, v) two power iterations on from a random u: near the top singular pair, as a
    trained model's are (from random ones sigma = u W v may be near 0, and w / sigma
    blows every rounding up), but not at it, so that one more iteration moves them."""
    mat = mat.astype(np.float64)
    u = rng.randn(mat.shape[0])
    for _ in range(iters):
        v = mat.T @ u
        v /= np.linalg.norm(v)
        u = mat @ v
        u /= np.linalg.norm(u)
    return u.astype(np.float32), v.astype(np.float32)


def snorm_randomize(variables, seed):
    """``randomize`` of the weights, and every spectral u and v near its weight's top
    singular pair (``near_top_pair``), in the JAX column order."""
    flat = randomize(variables, seed)
    rng = np.random.RandomState(seed + 1000)
    for path in [p for p in flat if p.startswith("spectral/") and p.endswith("weight_u")]:
        module = path[len("spectral/"):-len("/weight_u")]
        w = flat.get(f"params/{module}/weight", flat.get(f"{module}/weight"))
        u, v = near_top_pair(jax_snorm_matrix(module, w), rng)
        flat[path] = u.reshape(flat[path].shape)
        flat[path[:-1] + "v"] = v.reshape(flat[path[:-1] + "v"].shape)
    return flat


# -- one layer -------------------------------------------------------------------------
# (JAX module, port module, x shape in JAX's layout, JAX weight -> torch weight, JAX v ->
# torch v, x JAX layout -> torch layout)
def _conv_v(v, w):  # JAX columns (K, Cin) -> torch (Cin, K)
    kw, cin, _ = w.shape
    return v.reshape(kw, cin).T.reshape(-1)


CL = (lambda x: np.ascontiguousarray(x.transpose(0, 2, 1)))  # (B, T, C) <-> (B, C, T)
LAYERS = {
    "Conv1d": (lambda: jmod.Conv1d(6, 10, 31, stride=4, snorm=True),
               lambda: tmod.Conv1d(6, 10, 31, stride=4, snorm=True),
               (3, 157, 6), lambda w: w.transpose(2, 1, 0), _conv_v, CL),
    "ConvTranspose1d": (lambda: jmod.ConvTranspose1d(10, 6, 31, stride=4, padding=13,
                                                     snorm=True),
                        lambda: tmod.ConvTranspose1d(10, 6, 31, stride=4, padding=13,
                                                     snorm=True),
                        (3, 16, 10), lambda w: w.transpose(1, 2, 0), lambda v, w: v, CL),
    "Linear": (lambda: jmod.Linear(48, 12, snorm=True),
               lambda: tmod.Linear(48, 12, snorm=True),
               (3, 48), lambda w: w.T, lambda v, w: v, lambda x: x),
    "PReLU": (lambda: jmod.PReLU(12, snorm=True),
              lambda: tmod.PReLU(12, snorm=True),
              (3, 40, 12), lambda w: w, lambda v, w: v, CL),
}


def _layer_pair(kind, seed):
    """The JAX layer with random weights, u and v, and the port's layer with the same."""
    jm, tm, shape, w_map, v_map, _ = LAYERS[kind]
    jl = jm()
    variables = jl.init({"params": KEY}, jnp.zeros(shape), train=False)
    rng = np.random.RandomState(seed)
    params = {k: (rng.randn(*np.shape(v)) * (0.3 if k == "weight" else 0.1))
              .astype(np.float32) for k, v in variables["params"].items()}
    w = params["weight"]
    u, v = near_top_pair(jax_snorm_matrix("deconv" if "Transpose" in kind else "", w), rng)
    spec = {"weight_u": u, "weight_v": v}
    tl = tm()
    with torch.no_grad():
        tl.weight_orig.copy_(torch.from_numpy(np.ascontiguousarray(w_map(w))))
        if "bias" in params:
            tl.bias.copy_(torch.from_numpy(params["bias"]))
        tl.weight_u.copy_(torch.from_numpy(spec["weight_u"]))
        tl.weight_v.copy_(torch.from_numpy(np.ascontiguousarray(
            v_map(spec["weight_v"], w))))
    return jl, {"params": params, "spectral": spec}, tl


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", list(LAYERS))
def test_layer_matches_jax_spectral_normalize(kind, train):
    """Output, u and v after the forward, and the gradient with respect to weight_orig
    (through sigma, u and v held), against the JAX layer; eval mode leaves u and v."""
    jl, variables, tl = _layer_pair(kind, seed=3)
    _, _, shape, w_map, v_map, lay = LAYERS[kind]
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)

    def f(params):
        y, muts = jl.apply({"params": params, "spectral": variables["spectral"]},
                           jnp.asarray(x), train=train, mutable=["spectral"])
        return y, muts

    y_j, muts = f(variables["params"])
    gy = rng.randn(*np.shape(y_j)).astype(np.float32)
    grad_j = jax.grad(lambda p: jnp.sum(f(p)[0] * gy))(variables["params"])["weight"]
    tl.train(train)
    y = tl(torch.from_numpy(lay(x)))
    y.backward(torch.from_numpy(lay(gy)))
    assert _rel(lay(y.detach().numpy()), y_j) <= LAYER_TOL
    w = variables["params"]["weight"]
    u_want = np.asarray(muts["spectral"]["weight_u"])
    v_want = v_map(np.asarray(muts["spectral"]["weight_v"]), w)
    np.testing.assert_allclose(tl.weight_u.numpy(), u_want, rtol=LAYER_TOL, atol=LAYER_TOL)
    np.testing.assert_allclose(tl.weight_v.numpy(), v_want, rtol=LAYER_TOL, atol=LAYER_TOL)
    if not train:
        np.testing.assert_array_equal(tl.weight_u.numpy(), variables["spectral"]["weight_u"])
    assert _rel(tl.weight_orig.grad.numpy(), w_map(np.asarray(grad_j))) <= 1e-5
    assert tl.weight_u.dtype == tl.weight_v.dtype == torch.float32


@pytest.mark.parametrize("kind", list(LAYERS))
def test_layer_matches_torch_spectral_norm(kind):
    """torch's legacy ``nn.utils.spectral_norm`` (one power iteration) on the same
    weight, u and v: the same output, u and v in train mode, and the same state names,
    so that a state_dict of either loads into the other."""
    _, _, tl = _layer_pair(kind, seed=5)
    _, _, shape, _, _, lay = LAYERS[kind]
    ref_mod = {"Conv1d": lambda: torch.nn.Conv1d(6, 10, 31, stride=4),
               "ConvTranspose1d": lambda: torch.nn.ConvTranspose1d(10, 6, 31, stride=4,
                                                                   padding=13),
               "Linear": lambda: torch.nn.Linear(48, 12),
               "PReLU": lambda: torch.nn.PReLU(12)}[kind]()
    ref = torch.nn.utils.spectral_norm(ref_mod, dim=1 if kind == "ConvTranspose1d" else 0)
    ref.load_state_dict(tl.state_dict(), strict=True)
    x = torch.from_numpy(lay(np.random.RandomState(6).randn(*shape).astype(np.float32)))
    tl.train()
    ref.train()
    with torch.no_grad():
        y, y_ref = tl(x), ref(x)
    torch.testing.assert_close(y, y_ref, rtol=LAYER_TOL, atol=LAYER_TOL)
    for name in ("weight_u", "weight_v"):
        torch.testing.assert_close(getattr(tl, name), getattr(ref, name), rtol=LAYER_TOL,
                                   atol=LAYER_TOL)
    assert set(tl.state_dict()) == set(ref.state_dict())


def test_the_eps_form_is_jax_s():
    """v / (||v|| + eps), the JAX form (torch divides by max(||v||, eps)): the two differ
    below eps only, e.g. for an all-zero weight, where JAX's gives 0 and no NaN."""
    v = torch.full((4,), 1e-14)
    torch.testing.assert_close(tmod._l2normalize(v), v / (v.norm() + 1e-12))
    assert not torch.allclose(tmod._l2normalize(v),
                              torch.nn.functional.normalize(v, dim=0, eps=1e-12))


def test_snorm_block_runs_the_fused_op_and_its_gradient_reaches_weight_orig():
    """A snorm GConv1DBlock is the fused conv + bias + PReLU on w / sigma (no norm
    between), as the JAX block is: output and every gradient (weight_orig through sigma,
    bias, slope, input) against the JAX block."""
    jb = jmod.GConv1DBlock(2, 16, 31, stride=4, norm_type="snorm")
    rng = np.random.RandomState(7)
    x = rng.randn(2, 1024, 2).astype(np.float32)
    variables = jb.init({"params": KEY}, jnp.asarray(x), train=True)
    flat = snorm_randomize(dict(variables), seed=8)
    tree = unflatten_tree(flat)
    gy = rng.randn(2, 256, 16).astype(np.float32)

    def f(params, xx):
        y, _ = jb.apply({"params": params, "spectral": tree["spectral"]}, xx, train=True,
                        mutable=["spectral"])
        return jnp.sum(y * gy)

    gp, gx = jax.grad(f, argnums=(0, 1))(tree["params"], jnp.asarray(x))
    tb = tmod.GConv1DBlock(2, 16, 31, stride=4, norm_type="snorm")
    sd = generator_state_from_jax({"{}/enc_blocks_0/{}".format(*k.split("/", 1)): v
                                   for k, v in flatten_tree(tree).items()})
    tb.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()}, strict=True)
    tb.train()
    xt = torch.from_numpy(CL(x)).requires_grad_()
    y = tb(xt)
    y.backward(torch.from_numpy(CL(gy)))
    want = {"conv.weight_orig": np.asarray(gp["conv"]["weight"]).transpose(2, 1, 0),
            "conv.bias": np.asarray(gp["conv"]["bias"]),
            "act.weight": np.asarray(gp["act"]["weight"])}
    for name, p in tb.named_parameters():
        g = p.grad.numpy()
        assert float(np.abs(g - want[name]).max() / np.abs(want[name]).max()) <= 1e-5, name
    gxn = CL(xt.grad.numpy())
    assert float(np.abs(gxn - np.asarray(gx)).max() / np.abs(np.asarray(gx)).max()) <= 1e-5


# -- whole models ----------------------------------------------------------------------
def _jax_g(seed):
    cfg = JaxConfig(**G_TOY)
    G = jax_build_g(cfg)
    variables = G.init({"params": KEY, "z": KEY}, jnp.zeros((1, 1024, 1)), train=True)
    return G, snorm_randomize(dict(variables), seed)


def _port_g(flat):
    G = build_generator(SEGANConfig(**G_TOY))
    G.load_state_dict(generator_state_from_jax(flat), strict=True)
    return G


def _g_io(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 1024, 1).astype(np.float32) * 0.3,
            rng.randn(2, 16, 32).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _check_spectral(model_sd, new_state):
    """u and v of the port's model against the JAX ones, carried over by the bridge."""
    for k, v in new_state.items():
        if k.endswith(("weight_u", "weight_v")):
            assert _rel(model_sd[k].numpy(), v.numpy()) <= MODEL_TOL, k


def test_snorm_generator_matches_jax_in_train_and_eval():
    G, flat = _jax_g(seed=1)
    x, z = _g_io(seed=2)
    tree = unflatten_tree(flat)
    y_j, new = G.apply(tree, jnp.asarray(x), z=jnp.asarray(z), train=True,
                       mutable=["spectral"])
    tg = _port_g(flat).train()
    y = tg(torch.from_numpy(x), torch.from_numpy(z))
    assert _rel(y.detach().numpy(), y_j) <= MODEL_TOL
    after = generator_state_from_jax(flatten_tree({"params": tree["params"], **new}))
    _check_spectral(tg.state_dict(), after)
    # eval: the advanced u and v as they are, on another input
    x2, z2 = _g_io(seed=3)
    y_j = G.apply({"params": tree["params"], **new}, jnp.asarray(x2), z=jnp.asarray(z2))
    with torch.no_grad():
        y = tg.eval()(torch.from_numpy(x2), torch.from_numpy(z2))
    assert _rel(y.numpy(), y_j) <= MODEL_TOL
    # every conv and deconv of the encoder and decoder is normalised, the skips are not
    names = {n for n, _ in tg.named_buffers()}
    assert len(names) == 2 * 6 and not any(n.startswith("alpha") for n in names)


def _jax_d(pool, seed):
    cfg = JaxConfig(**D_TOY, dpool_type=pool)
    D = jdisc.build_discriminator(cfg)
    variables = D.init({"params": KEY, "phase": KEY}, jnp.zeros((1, 1024, 2)), train=True)
    return D, snorm_randomize(dict(variables), seed)


def _port_d(pool, flat):
    D = build_discriminator(SEGANConfig(**D_TOY, dpool_type=pool))
    D.load_state_dict(discriminator_state_from_jax(flat, 16, 32), strict=True)
    return D


# the spectrally normalised layers of each head, upstream's quirks included
SNORM_HEAD = {"none": {"fc.0", "fc.2", "fc.3"}, "conv": {"pool_conv", "fc"},
              "gmax": {"fc"}, "gavg": {"fc"}, "mlp": {"mlp.0", "mlp.1"}}


@pytest.mark.parametrize("pool", HEADS)
def test_snorm_discriminator_matches_jax_in_train_and_eval(pool, monkeypatch):
    D, flat = _jax_d(pool, seed=4)
    tree = unflatten_tree(flat)
    draws = record_phase(monkeypatch)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 1024, 2).astype(np.float32) * 0.5
    (y_j, _), new = D.apply(tree, jnp.asarray(x), train=True, mutable=["spectral"],
                            rngs={"phase": KEY})
    jax.effects_barrier()
    td = _port_d(pool, flat).train()
    y, _ = td(torch.from_numpy(CL(x)), phase=np.array(draws))
    got = CL(y.detach().numpy()) if pool == "mlp" else y.detach().numpy()
    assert _rel(got, y_j) <= MODEL_TOL
    after = discriminator_state_from_jax(flatten_tree({"params": tree["params"], **new}),
                                         16, 32)
    _check_spectral(td.state_dict(), after)
    heads = {n.rsplit(".", 1)[0] for n, _ in td.named_buffers()
             if not n.startswith("enc_blocks")}
    assert heads == SNORM_HEAD[pool]
    assert all(blk.norm is None for blk in td.enc_blocks)
    draws.clear()
    x2 = rng.randn(2, 1024, 2).astype(np.float32) * 0.5
    y_j, _ = D.apply({"params": tree["params"], **new}, jnp.asarray(x2), train=False,
                     rngs={"phase": jax.random.PRNGKey(5)})
    jax.effects_barrier()
    with torch.no_grad():
        y, _ = td.eval()(torch.from_numpy(CL(x2)), phase=np.array(draws))
    got = CL(y.numpy()) if pool == "mlp" else y.numpy()
    assert _rel(got, y_j) <= MODEL_TOL


def test_bf16_copies_keep_u_and_v_in_fp32():
    """The engine's bf16 inference copy of G casts the parameters alone, and a bf16 pass
    through ``_run`` advances the fp32 buffers of the master model in place."""
    cfg = SEGANConfig(**G_TOY, compute_dtype="bfloat16")
    seg = SEGAN(cfg, device="cpu")
    g16 = seg._g()
    assert all(p.dtype == torch.bfloat16 for p in g16.parameters())
    assert all(b.dtype == torch.float32 for b in g16.buffers())
    x, z = _g_io(seed=6)
    seg.infer_G(x, z)
    u0 = seg.G.enc_blocks[0].conv.weight_u.clone()
    seg.G.train()
    seg._run(seg.G, torch.from_numpy(x).bfloat16(), torch.from_numpy(z).bfloat16())
    u1 = seg.G.enc_blocks[0].conv.weight_u
    assert u1.dtype == torch.float32 and not torch.equal(u0, u1)
