"""Generator and Discriminator checkpoints: the counterpart of the torch and npz loaders
of ``segan_pytorch_tpu/utils/checkpoint.py``.

The port's models have the upstream torch state_dict names and layouts, so a
reference-format ``.ckpt`` (``torch.save({'step', 'state_dict'})``, which upstream
and the JAX ``export_torch_generator`` / ``export_torch_discriminator`` write) loads
with ``strict=True`` once legacy key names are migrated. A checkpoint that the JAX
trainer wrote (an npz pytree) is converted with ``generator_state_from_jax`` /
``discriminator_state_from_jax``.
"""
from __future__ import annotations

import zipfile
from typing import Dict, Mapping

import numpy as np
import torch


def _migrate_key(k: str) -> str:
    """Legacy upstream names: gen_enc -> enc_blocks; gen_dec -> dec_blocks with
    conv -> deconv."""
    if "gen_enc" in k:
        return k.replace("gen_enc", "enc_blocks")
    if "gen_dec" in k:
        return k.replace("gen_dec", "dec_blocks").replace("conv", "deconv")
    return k


def _is_npz(path: str) -> bool:
    """The JAX trainer's checkpoints are npz archives (zip of .npy); torch's zip
    checkpoints hold no .npy member, and legacy torch pickles are not zips at all."""
    try:
        with zipfile.ZipFile(path) as z:
            return any(n.endswith(".npy") for n in z.namelist())
    except zipfile.BadZipFile:
        return False


def _read_npz_state(path: str) -> Dict[str, np.ndarray]:
    """The model variables of an npz pytree, flattened to 'a/b/c' keys: those under
    'state_dict/' when the JAX trainer's Saver wrote it (which stores the optimizer
    state beside them, under 'optimizer/'), else every leaf."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    prefix = "state_dict/"
    if any(k.startswith(prefix) for k in flat):
        return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    return flat


def read_generator_state(path: str) -> Dict[str, torch.Tensor]:
    """A generator state_dict in the port's (upstream torch) names, from either a
    reference-format torch ``.ckpt`` or the JAX trainer's npz checkpoint."""
    if _is_npz(path):
        return generator_state_from_jax(_read_npz_state(path))
    st = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in st:
        st = st["state_dict"]
    return {_migrate_key(k): v for k, v in st.items()}


def load_generator(G: torch.nn.Module, path: str) -> None:
    """Load a checkpoint into G strictly: every key present, none extra."""
    G.load_state_dict(read_generator_state(path), strict=True)


def _save_model(model: torch.nn.Module, path: str, step: int) -> None:
    """``torch.save({'step', 'state_dict'})`` on the CPU, floating tensors in fp32 and
    integer buffers (BatchNorm's ``num_batches_tracked``) as they are."""
    sd = {k: (v.detach().to("cpu", torch.float32) if v.is_floating_point()
              else v.detach().cpu()).clone()
          for k, v in model.state_dict().items()}
    torch.save({"step": int(step), "state_dict": sd}, path)


def save_generator(G: torch.nn.Module, path: str, step: int = 0) -> None:
    """Write G as a reference-format torch checkpoint ({'step', 'state_dict'}), which
    upstream's loader and the JAX ``load_torch_generator`` read."""
    _save_model(G, path, step)


def read_discriminator_state(path: str, pool_slen: int,
                             last_fmaps: int) -> Dict[str, torch.Tensor]:
    """A discriminator state_dict in the port's (upstream torch) names, from either a
    reference-format torch ``.ckpt`` or the JAX trainer's npz checkpoint; ``pool_slen``
    and ``last_fmaps`` give the 'none' head's flatten shape (C, T)."""
    if _is_npz(path):
        return discriminator_state_from_jax(_read_npz_state(path), pool_slen, last_fmaps)
    st = torch.load(path, map_location="cpu", weights_only=True)
    return dict(st.get("state_dict", st))


def load_discriminator(D: torch.nn.Module, path: str) -> None:
    """Load a checkpoint into D strictly: every key present, none extra."""
    last_fmaps = D.enc_blocks[-1].conv.weight.shape[0]
    D.load_state_dict(read_discriminator_state(path, D.pool_slen, last_fmaps), strict=True)


def save_discriminator(D: torch.nn.Module, path: str, step: int = 0) -> None:
    """Write D as a reference-format torch checkpoint ({'step', 'state_dict'}), which
    upstream's loader and the JAX ``load_torch_discriminator`` read."""
    _save_model(D, path, step)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def generator_state_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Turn the JAX Generator's variables, flattened to 'a/b/c' numpy leaves (with or
    without a leading 'params/'), into the port's state_dict.

    conv (K, Cin, Cout) -> (Cout, Cin, K); deconv (K, Cin, Cout) -> (Cin, Cout, K);
    alpha skips (C,) -> (1, C, 1); PReLU slopes and biases unchanged. Only the
    'params' collection exists for the norm-free generator: any other collection
    (batch_stats, spectral) belongs to a norm the port does not have yet."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        elif parts[0] in ("batch_stats", "spectral"):
            raise NotImplementedError(
                f"{path}: bnorm/snorm generators are not ported yet (ROADMAP.md A1)")
        blk, rest = parts[0], parts[1:]
        if blk.startswith(("enc_blocks_", "dec_blocks_")):
            group, idx = blk.rsplit("_", 1)
            sub, leaf = rest
            if leaf == "weight" and sub == "conv":
                v = np.transpose(v, (2, 1, 0))
            elif leaf == "weight" and sub == "deconv":
                v = np.transpose(v, (1, 2, 0))
            out[f"{group}.{idx}.{sub}.{leaf}"] = _tensor(v)
        elif blk.startswith("alpha_") and rest == ["skip_k"]:
            out[f"{blk}.skip_k"] = _tensor(np.reshape(v, (1, -1, 1)))
        elif blk.startswith("alpha_") and rest[0] == "skip_k":
            if rest[1] == "weight":
                v = np.transpose(v, (2, 1, 0))
            out[f"{blk}.skip_k.{rest[1]}"] = _tensor(v)
        else:
            raise KeyError(f"unexpected generator variable {path!r}")
    return out


def discriminator_state_from_jax(flat: Mapping[str, np.ndarray], pool_slen: int,
                                 last_fmaps: int) -> Dict[str, torch.Tensor]:
    """Turn the JAX Discriminator's variables, flattened to 'a/b/c' numpy leaves ('params/'
    and 'batch_stats/' collections; a leaf without a collection is a param), into the
    port's state_dict: the inverse of the JAX ``load_torch_discriminator``.

    conv (K, Cin, Cout) -> (Cout, Cin, K); Linear (in, out) -> (out, in), fc_0's input
    reordered from the JAX flatten (T, C) to upstream's (C, T) with C = ``last_fmaps``,
    T = ``pool_slen``; PReLU slopes, biases and BatchNorm leaves unchanged. Every
    BatchNorm gets ``num_batches_tracked`` 0, as the JAX export writes it."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in flat.items():
        parts = path.split("/")
        coll = "params"
        if parts[0] in ("params", "batch_stats", "spectral"):
            coll, parts = parts[0], parts[1:]
        if coll == "spectral":
            raise NotImplementedError(f"{path}: a spectral-norm D is not ported yet "
                                      "(ROADMAP.md, queue A item 4)")
        name, rest = parts[0], parts[1:]
        v = np.asarray(v)
        if name.startswith("enc_blocks_"):
            idx = name.rsplit("_", 1)[1]
            sub, leaf = rest
            if sub == "conv" and leaf == "weight":
                v = np.transpose(v, (2, 1, 0))
            out[f"enc_blocks.{idx}.{sub}.{leaf}"] = _tensor(v)
            if sub == "norm" and leaf == "weight":
                out[f"enc_blocks.{idx}.norm.num_batches_tracked"] = torch.tensor(0)
        elif name.startswith(("fc_", "mlp_")):
            group, idx = name.rsplit("_", 1)
            (leaf,) = rest
            if leaf == "weight" and v.ndim == 3:  # mlp conv (K, Cin, Cout)
                v = np.transpose(v, (2, 1, 0))
            elif leaf == "weight" and v.ndim == 2:  # Linear (in, out)
                v = v.T
                if name == "fc_0":  # (256, T*C) -> (256, T, C) -> (256, C, T)
                    v = np.transpose(v.reshape(v.shape[0], pool_slen, last_fmaps),
                                     (0, 2, 1)).reshape(v.shape[0], -1)
            out[f"{group}.{idx}.{leaf}"] = _tensor(v)
        elif name in ("fc", "pool_conv"):
            (leaf,) = rest
            if leaf == "weight":
                v = v.T if v.ndim == 2 else np.transpose(v, (2, 1, 0))
            out[f"{name}.{leaf}"] = _tensor(v)
        else:
            raise KeyError(f"unexpected discriminator variable {path!r}")
    return out
