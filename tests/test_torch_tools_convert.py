"""``segan_pytorch_tpu_torch/weight_converter.py`` against the repo's
``weight_converter.py`` at toy width (slice 1024, fmaps 8/16/32): the same torch
checkpoint through both gives the same npz tree (keys in order, arrays bit for bit, the
same meta), the same tree back through both ``--to_torch`` gives the same payload (keys
in order, tensors bit for bit, the step), and the port's G loaded strictly from its own
``--to_torch`` output equals the JAX G applied to the tree (1e-5, relative to the largest
JAX value).

Cases: G norm-free, bnorm (running statistics) and snorm (u and v, 'weight_orig'); D
bnorm and snorm with the 'none' head; a G under upstream's legacy names ('gen_enc',
'gen_dec' with 'conv') written with spectral norm's 'weight_orig'; and a sinc D, whose
filter bank only the port carries (every other key equal). The weights are the JAX
models' initial variables randomised by ``test_torch_discriminator.randomize`` (and
``test_torch_wsegan_models.snorm_randomize``: u and v near each weight's top singular
pair, so that eval-mode sigma is the weight's). The root tool runs in this process
(``runpy``, ``sys.argv`` patched).
"""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from segan_pytorch_tpu.models import discriminator as jdisc
from segan_pytorch_tpu.models.generator import build_generator as jax_build_g
from segan_pytorch_tpu.utils.config import SEGANConfig as JaxConfig
from segan_pytorch_tpu_torch import weight_converter
from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
from segan_pytorch_tpu_torch.models.generator import build_generator
from segan_pytorch_tpu_torch.utils import checkpoint as tck
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
from test_torch_discriminator import randomize
from test_torch_wsegan_models import snorm_randomize

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
TOL = 1e-5
G_TOY = dict(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4], gkwidth=31,
             z_dim=32)
D_TOY = dict(slice_size=1024, gkwidth=31, denc_fmaps=[8, 16, 32], denc_poolings=[4, 4, 4],
             dpool_slen=16)
SINC_TOY = dict(D_TOY, sinc_conv=True, dpool_slen=64, no_bias=True)
SINC = ("params/sinc_conv/filt_b1", "params/sinc_conv/filt_band")

# case: (G or D, config, snorm)
CASES = {
    "G": ("G", G_TOY, False),
    "G_bnorm": ("G", dict(G_TOY, gnorm_type="bnorm", no_bias=True), False),
    "G_snorm": ("G", dict(G_TOY, gnorm_type="snorm"), True),
    "D_bnorm": ("D", D_TOY, False),
    "D_snorm": ("D", dict(D_TOY, dnorm_type="snorm"), True),
    "G_legacy_snorm": ("G", dict(G_TOY, gnorm_type="snorm"), True),
    "D_sinc": ("D", SINC_TOY, False),
}


def _jax_model(which, kw, snorm, seed):
    """The JAX model and its randomised variables, flattened with their collections."""
    cfg = JaxConfig(**kw)
    if which == "G":
        model = jax_build_g(cfg)
        v = model.init({"params": KEY, "z": KEY}, jnp.zeros((1, 1024, 1)), train=True)
    else:
        model = jdisc.build_discriminator(cfg)
        v = model.init({"params": KEY, "phase": KEY}, jnp.zeros((1, 1024, 2)), train=True)
    return model, (snorm_randomize if snorm else randomize)(dict(v), seed)


def _port_model(which, kw, flat=None):
    cfg = SEGANConfig(**kw)
    if which == "G":
        model = build_generator(cfg)
        state = tck.generator_state_from_jax(flat) if flat is not None else None
    else:
        model = build_discriminator(cfg)
        state = (tck.discriminator_state_from_jax(flat, cfg.dpool_slen, cfg.denc_fmaps[-1])
                 if flat is not None else None)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model


def _legacy(sd):
    """Upstream's old names: enc_blocks -> gen_enc, dec_blocks.i.deconv -> gen_dec.i.conv."""
    return {k.replace("enc_blocks", "gen_enc").replace("dec_blocks", "gen_dec")
            .replace(".deconv.", ".conv."): v for k, v in sd.items()}


def _root(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["weight_converter.py", *argv])
    runpy.run_path(str(ROOT / "weight_converter.py"), run_name="__main__")


def _npz(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _shape_args(which, kw):
    if which == "G":
        return ["--which", "G"]
    return ["--which", "D", "--dpool_slen", str(kw["dpool_slen"]), "--last_fmaps",
            str(kw["denc_fmaps"][-1])]


@pytest.mark.parametrize("case", list(CASES))
def test_converter_matches_the_root_tool(case, tmp_path, monkeypatch, capsys):
    which, kw, snorm = CASES[case]
    model, flat = _jax_model(which, kw, snorm, seed=len(case))
    port = _port_model(which, kw, flat)
    src = str(tmp_path / "src.ckpt")
    if case == "G_legacy_snorm":
        sd = _legacy(port.state_dict())
        assert any(k.startswith("gen_dec.") and k.endswith(".conv.weight_orig") for k in sd)
        torch.save({"step": 0, "state_dict": sd}, src)
    elif which == "G":
        tck.save_generator(port, src)
    else:
        tck.save_discriminator(port, src)
    shape = _shape_args(which, kw)

    # torch -> npz: the same keys in the same order, arrays and meta
    _root([src, "--out", str(tmp_path / "root.npz"), *shape], monkeypatch)
    out = weight_converter.main([src, "--out", str(tmp_path / "port.npz"), *shape])
    assert out == str(tmp_path / "port.npz") and "Wrote" in capsys.readouterr().out
    want, got = _npz(tmp_path / "root.npz"), _npz(tmp_path / "port.npz")
    if case == "D_sinc":  # the bank: the port's alone, as it was
        for k in SINC:
            np.testing.assert_array_equal(got.pop(f"state_dict/{k}"), flat[k])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert tck.load_pytree(str(tmp_path / "port.npz"))[1] == {"source": src}

    # npz -> torch: the same payload
    _root([str(tmp_path / "root.npz"), "--to_torch", "--out", str(tmp_path / "root.torch"),
           *shape], monkeypatch)
    weight_converter.main([str(tmp_path / "port.npz"), "--to_torch", "--out",
                           str(tmp_path / "port.torch"), *shape])
    want = torch.load(tmp_path / "root.torch", weights_only=True)
    got = torch.load(tmp_path / "port.torch", weights_only=True)
    assert got["step"] == want["step"] == 0
    got_sd, want_sd = dict(got["state_dict"]), want["state_dict"]
    if case == "D_sinc":
        assert list(got_sd)[:2] == ["sinc_conv.filt_b1", "sinc_conv.filt_band"]
        for k in SINC:
            np.testing.assert_array_equal(got_sd.pop(k.replace("params/", "").replace(
                "/", ".")).numpy(), flat[k])
    assert list(got_sd) == list(want_sd)
    for k, v in want_sd.items():
        assert got_sd[k].dtype == v.dtype and torch.equal(got_sd[k], v), k

    # the port's output strict-loads; G equals the JAX G on the tree
    back = _port_model(which, kw)
    back.load_state_dict(got["state_dict"], strict=True)
    if which == "G":
        rng = np.random.RandomState(7)
        x = (rng.randn(2, 1024, 1) * 0.3).astype(np.float32)
        z = rng.randn(2, 16, 32).astype(np.float32)
        tree = tck.load_pytree(str(tmp_path / "root.npz"))[0]["state_dict"]
        y_j = np.asarray(model.apply(tree, jnp.asarray(x), z=jnp.asarray(z), train=False))
        with torch.no_grad():
            y = back.eval()(torch.from_numpy(x), torch.from_numpy(z)).numpy()
        assert float(np.abs(y - y_j).max() / np.abs(y_j).max()) <= TOL


def test_step_of_the_meta_reaches_the_payload(tmp_path):
    """--to_torch takes the step from the npz meta, as the JAX tool does."""
    _, flat = _jax_model("G", G_TOY, False, seed=3)
    tck.save_pytree(str(tmp_path / "g.npz"), {"state_dict": tck.unflatten_tree(flat)},
                    meta={"step": 42})
    out = weight_converter.main([str(tmp_path / "g.npz"), "--to_torch"])
    assert out == str(tmp_path / "g.npz") + ".torch"
    payload = torch.load(out, weights_only=True)
    assert payload["step"] == 42
    _port_model("G", G_TOY).load_state_dict(payload["state_dict"], strict=True)


def test_pytree_format_round_trips_both_ways(tmp_path):
    """The port's npz writer and reader against the JAX package's, both directions."""
    from segan_pytorch_tpu.utils import checkpoint as jck

    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "c": np.int64(3)}, "d": np.ones(2, np.float16)}
    tck.save_pytree(str(tmp_path / "p"), tree, meta={"step": 1})
    jck.save_pytree(str(tmp_path / "j"), tree, meta={"step": 1})
    for path in ("p.npz", "j.npz"):
        for load in (tck.load_pytree, jck.load_pytree):
            got, meta = load(str(tmp_path / path))
            assert meta == {"step": 1}
            assert list(tck.flatten_tree(got)) == ["a/b", "a/c", "d"]
            for k, v in tck.flatten_tree(tree).items():
                g = tck.flatten_tree(got)[k]
                assert g.dtype == v.dtype and np.array_equal(g, v)
    assert tck.load_pytree(str(tmp_path / "p.npz"))[1] == {"step": 1}
    jck.save_pytree(str(tmp_path / "n"), tree)
    assert tck.load_pytree(str(tmp_path / "n.npz"))[1] is None
