"""Generator checkpoints: the counterpart of the torch and npz loaders of
``segan_pytorch_tpu/utils/checkpoint.py``.

The port's Generator has the upstream torch state_dict names and layouts, so a
reference-format ``.ckpt`` (``torch.save({'step', 'state_dict'})``, which upstream
and the JAX ``export_torch_generator`` write) loads with ``strict=True`` once legacy
key names are migrated. A checkpoint that the JAX trainer wrote (an npz pytree) is
converted with ``generator_state_from_jax``.
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


def read_generator_state(path: str) -> Dict[str, torch.Tensor]:
    """A generator state_dict in the port's (upstream torch) names, from either a
    reference-format torch ``.ckpt`` or the JAX trainer's npz checkpoint."""
    if _is_npz(path):
        with np.load(path, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files if k != "__meta__"}
        prefix = "state_dict/"
        flat = {(k[len(prefix):] if k.startswith(prefix) else k): v
                for k, v in flat.items()}
        return generator_state_from_jax(flat)
    st = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in st:
        st = st["state_dict"]
    return {_migrate_key(k): v for k, v in st.items()}


def load_generator(G: torch.nn.Module, path: str) -> None:
    """Load a checkpoint into G strictly: every key present, none extra."""
    G.load_state_dict(read_generator_state(path), strict=True)


def save_generator(G: torch.nn.Module, path: str, step: int = 0) -> None:
    """Write G as a reference-format torch checkpoint ({'step', 'state_dict'}), which
    upstream's loader and the JAX ``load_torch_generator`` read."""
    sd = {k: v.detach().to("cpu", torch.float32).clone()
          for k, v in G.state_dict().items()}
    torch.save({"step": int(step), "state_dict": sd}, path)


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
