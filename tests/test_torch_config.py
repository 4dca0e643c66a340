"""The framework-neutral pieces the port copies rather than imports (importing
segan_pytorch_tpu imports jax, which the CUDA machine lacks) stay equal to their
originals; and the port imports no jax at all."""
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from segan_pytorch_tpu.data import wav_io as jwav
from segan_pytorch_tpu.ops import signal as jsig
from segan_pytorch_tpu.parallel import inference as jinf
from segan_pytorch_tpu.utils import config as jcfg
from segan_pytorch_tpu_torch.data import wav_io as twav
from segan_pytorch_tpu_torch.ops import signal as tsig
from segan_pytorch_tpu_torch.parallel import inference as tinf
from segan_pytorch_tpu_torch import train as ttrain
from segan_pytorch_tpu_torch.utils import config as tcfg

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "segan_pytorch_tpu_torch"


def test_config_fields_and_defaults_equal():
    j = {f.name: f for f in dataclasses.fields(jcfg.SEGANConfig)}
    t = {f.name: f for f in dataclasses.fields(tcfg.SEGANConfig)}
    assert list(j) == list(t)
    assert jcfg.SEGANConfig().to_dict() == tcfg.SEGANConfig().to_dict()
    for kw in (dict(no_bias=True), dict(no_bias=False, bias=None)):
        assert jcfg.SEGANConfig(**kw).bias == tcfg.SEGANConfig(**kw).bias


def test_both_load_the_same_train_opts(tmp_path):
    """A legacy upstream train.opts: boolean l1_loss, TPU knobs, an unknown key."""
    opts = dict(tcfg.SEGANConfig(no_bias=True).to_dict(), l1_loss=True,
                use_pallas=True, conv_grad="custom", not_a_field=3)
    del opts["reg_loss"], opts["bias"]
    path = tmp_path / "train.opts"
    path.write_text(json.dumps(opts))
    j, t = jcfg.load_train_opts(str(path)), tcfg.load_train_opts(str(path))
    assert j.to_dict() == t.to_dict()
    assert t.legacy_l1_loss is True and t.reg_loss == "l1_loss" and t.bias is False
    assert t._unknown == j._unknown == {"not_a_field": 3}
    out = tcfg.dump_train_opts(t, str(tmp_path / "dump"))
    assert jcfg.load_train_opts(out).to_dict() == t.to_dict()


def test_signal_helpers_equal():
    pcm = np.random.RandomState(0).randint(-32768, 32767, 5000).astype(np.int16)
    x = tsig.normalize_wave_minmax(pcm)
    np.testing.assert_array_equal(x, jsig.normalize_wave_minmax(pcm))
    np.testing.assert_array_equal(tsig.abs_normalize_wave_minmax(pcm),
                                  jsig.abs_normalize_wave_minmax(pcm))
    for coef in (0.95, 0.0):
        np.testing.assert_array_equal(tsig.pre_emphasize_np(x, coef),
                                      jsig.pre_emphasize_np(x, coef))
        np.testing.assert_array_equal(tsig.de_emphasize_np(x, coef),
                                      jsig.de_emphasize_np(x, coef))


@pytest.mark.parametrize("overlap", [0.0, 0.25])
def test_chunk_grid_and_overlap_add_equal(overlap):
    wav = np.random.RandomState(1).randn(2500).astype(np.float32)
    grid, hop, n = tinf.chunk_grid(wav, 1024, overlap)
    grid_j, hop_j, n_j = jinf.chunk_grid(wav, 1024, overlap)
    assert (hop, n) == (hop_j, n_j)
    np.testing.assert_array_equal(grid, grid_j)
    np.testing.assert_array_equal(tinf.overlap_add(grid, hop, 2500),
                                  jinf.overlap_add(grid, hop, 2500))


@pytest.mark.parametrize("subtype", ["float", "pcm16"])
def test_wav_io_equal(tmp_path, subtype):
    wav = np.random.RandomState(2).uniform(-1.2, 1.2, 3000).astype(np.float32)
    twav.write_wav(str(tmp_path / "t.wav"), wav, 16000, subtype=subtype)
    jwav.write_wav(str(tmp_path / "j.wav"), wav, 16000, subtype=subtype)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    rate, y = twav.read_wav_raw(str(tmp_path / "t.wav"))
    rate_j, y_j = jwav.read_wav_raw(str(tmp_path / "t.wav"))
    assert rate == rate_j == 16000
    np.testing.assert_array_equal(y, y_j)


def _root_train_parser():
    spec = importlib.util.spec_from_file_location("root_train", ROOT / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices,
                     type(a).__name__) for a in parser._actions if a.dest != "help"}


def test_train_parser_equals_train_py():
    """The port's CLI takes every option of train.py, with the same spelling, default,
    arity, type and choices, plus its own --device."""
    want, got = _options(_root_train_parser()), _options(ttrain.build_parser())
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    argv = ["--batch_size", "300", "--no_bias", "--genc_fmaps", "8", "16", "--no-cuda"]
    assert vars(_root_train_parser().parse_args(argv)).items() <= vars(
        ttrain.build_parser().parse_args(argv)).items()


@pytest.mark.parametrize("rate", [16000, 8000, 22050])
def test_wav_16k_helpers_equal(tmp_path, rate):
    from scipy.io import wavfile

    rng = np.random.RandomState(3)
    for name, data in (("i16", (rng.randn(7001) * 3000).astype(np.int16)),
                       ("f32", rng.uniform(-1, 1, (5000, 2)).astype(np.float32)),
                       ("u8", rng.randint(0, 255, 4000).astype(np.uint8))):
        path = str(tmp_path / f"{name}.wav")
        wavfile.write(path, rate, data)
        assert twav.wav_num_samples_16k(path) == jwav.wav_num_samples_16k(path)
        (y, sr), (y_j, sr_j) = twav.read_wav_16k(path), jwav.read_wav_16k(path)
        assert sr == sr_j and y.dtype == y_j.dtype
        np.testing.assert_array_equal(y, y_j)
        np.testing.assert_array_equal(twav._to_float(data), jwav._to_float(data))
    (tmp_path / "junk.wav").write_bytes(b"not a riff file at all")
    assert twav.wav_num_samples_16k(str(tmp_path / "junk.wav")) is None


@pytest.mark.parametrize("n,window,stride", [(24000, 4096, 0.5), (4096, 4096, 0.5),
                                             (4095, 4096, 1.0), (50000, 16384, 0.25)])
def test_slice_signal_indices_equal(n, window, stride):
    assert tsig.slice_signal_indices(n, window, stride) == jsig.slice_signal_indices(
        n, window, stride)


def test_port_sources_import_no_jax():
    """No module of the port and not chip_smoke.py imports jax, flax, optax, the JAX
    package, or the repo's root scripts serve.py, train.py and clean.py (serve.py's
    handlers import jax, so such an import would fail on the card at the first
    request)."""
    pat = re.compile(r"^\s*(import|from)\s+((jax|flax|optax|segan_pytorch_tpu)\b(?!_torch)"
                     r"|(serve|train|clean)\b)", re.M)
    for line in ("import jax", "from segan_pytorch_tpu.ops import signal", "import serve",
                 "    from train import build_parser", "import clean as c"):
        assert pat.search(line), line
    for line in ("from segan_pytorch_tpu_torch import train", "from . import serve",
                 "from .train import main", "import serve_utils", "import trainer"):
        assert not pat.search(line), line
    offenders = [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
                 if pat.search(p.read_text())]
    offenders += [p for p in ("chip_smoke.py",) if pat.search((ROOT / p).read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("module", ["data.aco", "data.vc_dataset", "data.se_dataset",
                                    "metrics.f0", "metrics.stoi"])
def test_host_copies_import_neither_jax_nor_torch(module):
    """The host-side copies of the datasets and metrics import numpy and scipy, not jax,
    the JAX package or torch: the evaluation pool's spawned workers import the metrics
    and ``data/aco.py`` alone."""
    code = (f"import sys, importlib; importlib.import_module('segan_pytorch_tpu_torch."
            f"{module}'); print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            f"{{'jax', 'flax', 'torch', 'segan_pytorch_tpu'}}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", (proc.stdout,
                                                                  proc.stderr[-2000:])


def test_port_runs_with_jax_unimportable(tmp_path):
    """With sys.modules['jax'] = None any `import jax` raises: import every module of
    the port and run a toy generate() on the CPU."""
    code = f"""
import sys, pkgutil, importlib
sys.modules['jax'] = None
import numpy as np
import segan_pytorch_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
    importlib.import_module(m.name)
from segan_pytorch_tpu_torch.models.segan import SEGAN
from segan_pytorch_tpu_torch.utils.config import SEGANConfig
cfg = SEGANConfig(slice_size=1024, genc_fmaps=[8, 16, 32], genc_poolings=[4, 4, 4],
                  z_dim=32, no_bias=True)
y, g_c = SEGAN(cfg, device='cpu').generate(np.random.RandomState(0).randn(3000) * 0.1)
assert y.shape == (3000,) and np.isfinite(y).all() and g_c.shape == (3, 16, 32)
assert not [m for m in sys.modules if m.split('.')[0] in ('segan_pytorch_tpu', 'flax', 'optax')]
print('ok')
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
