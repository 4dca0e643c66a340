"""The port's whole Generator against the JAX Generator at toy width (fmaps [8, 16, 32],
K=31, pools 4, z_dim 32, slice 1024), and the checkpoint bridge both ways: JAX export ->
the port's strict load, and the port's save -> JAX load_torch_generator."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models.generator import build_generator as jax_build
from segan_pytorch_tpu.utils.checkpoint import (export_torch_generator, flatten_tree,
                                                load_torch_generator, save_pytree,
                                                unflatten_tree)
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.utils.checkpoint import (generator_state_from_jax,
                                                      load_generator, save_generator)
from segan_pytorch_tpu_torch.utils.config import SEGANConfig

TOL = 5e-5  # fp32 through 6 conv layers + skips, two CPU backends summing differently
KEY = jax.random.PRNGKey(0)
TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4],
           gkwidth=31, z_dim=32)


def _randomize(params, seed):
    """Weights at 1/sqrt(K*Cin), PReLU slopes U(0, 0.3), alphas U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_tree(params).items():
        if path.endswith("act/weight"):
            out[path] = rng.uniform(0, 0.3, v.shape)
        elif v.ndim == 3:
            out[path] = rng.randn(*v.shape) / np.sqrt(v.shape[0] * v.shape[1])
        elif path.endswith("skip_k"):
            out[path] = rng.uniform(0.5, 1.5, v.shape)
        else:
            out[path] = rng.randn(*v.shape) * 0.1
    return {k: v.astype(np.float32) for k, v in out.items()}


def _jax_g(seed=1, **kw):
    cfg = JaxConfig(**TOY, **kw)
    G = jax_build(cfg)
    x = jnp.zeros((1, 1024, 1))
    flat = _randomize(G.init({"params": KEY, "z": KEY}, x)["params"], seed)
    return cfg, G, flat


def _io(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 1024, 1).astype(np.float32) * 0.3,
            rng.randn(2, 16, 32).astype(np.float32))


def _port_out(G, x, z):
    with torch.no_grad():
        return G.eval()(torch.from_numpy(x), torch.from_numpy(z)).numpy()


@pytest.mark.parametrize("skip_merge,skip_type", [
    ("concat", "alpha"),
    ("sum", "alpha"),
    ("concat", "constant"),
    ("concat", "conv"),
])
def test_forward_matches_jax(skip_merge, skip_type):
    cfg, G, flat = _jax_g(skip_merge=skip_merge, skip_type=skip_type)
    x, z = _io()
    y_j = np.asarray(G.apply({"params": unflatten_tree(flat)}, jnp.asarray(x),
                             z=jnp.asarray(z), train=False))
    tg = build_generator(SEGANConfig(**TOY, skip_merge=skip_merge, skip_type=skip_type))
    tg.load_state_dict(generator_state_from_jax(flat), strict=True)
    y = _port_out(tg, x, z)
    assert y.shape == (2, 1024, 1)
    np.testing.assert_allclose(y, y_j, rtol=TOL, atol=TOL)


def test_hidden_states_match_jax():
    """ret_hid: every encoder/decoder activation (B, T, C), the pre-z bottleneck
    included — generate()'s g_c is the last encoder one."""
    _, G, flat = _jax_g(no_bias=True, seed=2)
    x, z = _io(1)
    _, hall_j = G.apply({"params": unflatten_tree(flat)}, jnp.asarray(x),
                        z=jnp.asarray(z), ret_hid=True, train=False)
    tg = build_generator(SEGANConfig(**TOY, no_bias=True))
    tg.load_state_dict(generator_state_from_jax(flat), strict=True)
    with torch.no_grad():
        _, hall = tg.eval()(torch.from_numpy(x), torch.from_numpy(z), ret_hid=True)
    assert set(hall) == set(hall_j)
    for k in hall:
        np.testing.assert_allclose(hall[k].numpy(), np.asarray(hall_j[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_jax_export_strict_loads_into_port(tmp_path):
    """--no_bias: the encoder has no conv bias, the decoder deconvs keep theirs."""
    cfg, G, flat = _jax_g(no_bias=True, seed=3)
    ckpt = str(tmp_path / "g.ckpt")
    export_torch_generator({"params": unflatten_tree(flat)}, ckpt)
    tg = build_generator(SEGANConfig(**TOY, no_bias=True))
    load_generator(tg, ckpt)
    x, z = _io(2)
    y_j = np.asarray(G.apply({"params": unflatten_tree(flat)}, jnp.asarray(x),
                             z=jnp.asarray(z), train=False))
    np.testing.assert_allclose(_port_out(tg, x, z), y_j, rtol=TOL, atol=TOL)


def test_port_save_loads_into_jax(tmp_path):
    cfg = SEGANConfig(**TOY, no_bias=True)
    tg = build_generator(cfg, torch.Generator().manual_seed(5))
    with torch.no_grad():
        for name, p in tg.named_parameters():
            if name.endswith("act.weight"):
                p.uniform_(0, 0.3)
    ckpt = str(tmp_path / "g.ckpt")
    save_generator(tg, ckpt)
    tree = load_torch_generator(ckpt)
    x, z = _io(3)
    G = jax_build(JaxConfig(**TOY, no_bias=True))
    y_j = np.asarray(G.apply({"params": tree["params"]}, jnp.asarray(x),
                             z=jnp.asarray(z), train=False))
    np.testing.assert_allclose(_port_out(tg, x, z), y_j, rtol=TOL, atol=TOL)


def test_jax_trainer_npz_checkpoint_loads(tmp_path):
    """The JAX trainer's Saver payload ({'state_dict': {'params': ...}} as an npz)."""
    _, G, flat = _jax_g(seed=4)
    path = str(tmp_path / "weights_EOE_G-Generator-10.npz")
    save_pytree(path, {"state_dict": {"params": unflatten_tree(flat)}}, meta={"step": 10})
    tg = build_generator(SEGANConfig(**TOY))
    load_generator(tg, path)
    x, z = _io(4)
    y_j = np.asarray(G.apply({"params": unflatten_tree(flat)}, jnp.asarray(x),
                             z=jnp.asarray(z), train=False))
    np.testing.assert_allclose(_port_out(tg, x, z), y_j, rtol=TOL, atol=TOL)


def test_legacy_keys_migrate_and_load_is_strict(tmp_path):
    tg = build_generator(SEGANConfig(**TOY), torch.Generator().manual_seed(6))
    sd = tg.state_dict()
    legacy = {}
    for k, v in sd.items():
        k = k.replace("enc_blocks", "gen_enc")
        k = k.replace("dec_blocks", "gen_dec").replace("deconv", "conv")
        legacy[k] = v
    path = str(tmp_path / "legacy.ckpt")
    torch.save({"step": 3, "state_dict": legacy}, path)
    other = build_generator(SEGANConfig(**TOY), torch.Generator().manual_seed(7))
    load_generator(other, path)
    for k, v in other.state_dict().items():
        assert torch.equal(v, sd[k]), k
    legacy.pop(next(iter(legacy)))
    torch.save({"state_dict": legacy}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_generator(other, path)
