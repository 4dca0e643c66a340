"""Generator and Discriminator checkpoints: the counterpart of the torch and npz loaders
and of the ``Saver`` of ``segan_pytorch_tpu/utils/checkpoint.py``.

The port's models have the upstream torch state_dict names and layouts, so a
reference-format ``.ckpt`` (``torch.save({'step', 'state_dict'})``, which upstream
and the JAX ``export_torch_generator`` / ``export_torch_discriminator`` write) loads
with ``strict=True`` once legacy key names are migrated. A checkpoint that the JAX
trainer wrote (an npz pytree) is converted with ``generator_state_from_jax`` /
``discriminator_state_from_jax``.

``Saver`` keeps the reference's rotating JSON index and file names; its payloads are
reference-format torch files with the optimizer state beside the weights, so the JAX
``load_torch_generator`` and ``purge_ckpts.py`` read what the port's trainer writes.
"""
from __future__ import annotations

import json
import os
import threading
import zipfile
from typing import Dict, Mapping, Optional

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


def _host_copy(v: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of v on the CPU (in `dtype`), never a view of v's own memory."""
    out = v.detach().to("cpu", dtype or v.dtype)
    return out.clone() if out.data_ptr() == v.data_ptr() else out


def _cpu_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The state_dict copied to the CPU, floating tensors in fp32 and integer buffers
    (BatchNorm's ``num_batches_tracked``) as they are."""
    return {k: _host_copy(v, torch.float32 if v.is_floating_point() else None)
            for k, v in model.state_dict().items()}


def _to_cpu(tree):
    """Every tensor of a nested dict/list (an optimizer's state_dict) copied to the
    CPU."""
    if torch.is_tensor(tree):
        return _host_copy(tree)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _save_model(model: torch.nn.Module, path: str, step: int) -> None:
    """``torch.save({'step', 'state_dict'})`` of ``_cpu_state``."""
    torch.save({"step": int(step), "state_dict": _cpu_state(model)}, path)


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


class Saver:
    """Rotating-index checkpoint writer with the reference's semantics: the index
    ``{prefix}checkpoints`` holds {'latest': [...], 'current': name}; payload files are
    ``weights_{prefix}[best_]{model}-{step}.ckpt`` holding {'step', 'state_dict',
    'optimizer'}; a save beyond ``max_ckpts`` + 1 entries deletes the oldest; the payload
    is written first and the index second, so a crash between them leaves an orphan
    payload, never an index that points at nothing.

    With ``async_write=True`` a save copies the model and optimizer state to the CPU on
    the calling thread (one device-to-host copy, which waits for the device) and writes
    the file on a background thread. One write is in flight at a time (a new save joins
    the previous); ``flush()`` joins it and re-raises its failure."""

    def __init__(self, save_path: str, max_ckpts: int = 5, prefix: str = "",
                 async_write: bool = False):
        self.save_path = save_path
        self.ckpt_path = os.path.join(save_path, f"{prefix}checkpoints")
        self.max_ckpts = max_ckpts
        self.prefix = prefix
        self.async_write = async_write
        self._inflight: Optional[threading.Thread] = None
        self._bg_error: Optional[BaseException] = None

    def flush(self):
        """Wait for any in-flight background write; re-raise its failure."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if self._bg_error is not None:
            err, self._bg_error = self._bg_error, None
            raise err

    def save(self, model_name: str, step: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None,
             best_val: bool = False, trained_steps: Optional[int] = None) -> str:
        """Save `model` (and `optimizer`'s state) under the name of step `step`; the
        payload's 'step' is `trained_steps` (default `step`). Returns the payload's
        path."""
        self.flush()
        payload = {"step": int(step if trained_steps is None else trained_steps),
                   "state_dict": _cpu_state(model)}
        if optimizer is not None:
            payload["optimizer"] = _to_cpu(optimizer.state_dict())
        name = f"{self.prefix}{'best_' if best_val else ''}{model_name}-{step}.ckpt"
        if not self.async_write:
            return self._write(name, payload)

        def run():
            try:
                self._write(name, payload)
            except BaseException as e:  # surfaced on the next save()/flush()
                self._bg_error = e

        self._inflight = threading.Thread(target=run, name=f"saver-{name}", daemon=False)
        self._inflight.start()
        return os.path.join(self.save_path, "weights_" + name)

    def _write(self, model_path: str, payload: dict) -> str:
        os.makedirs(self.save_path, exist_ok=True)
        if os.path.exists(self.ckpt_path):
            with open(self.ckpt_path, "r") as f:
                ckpts = json.load(f)
        else:
            ckpts = {"latest": [], "current": []}
        latest = ckpts["latest"]
        if len(latest) > 0 and self.max_ckpts is not None and len(latest) > self.max_ckpts:
            todel = latest[0]
            try:
                os.remove(os.path.join(self.save_path, "weights_" + todel))
            except FileNotFoundError:
                # drop the dangling entry all the same: a crash between payload and
                # index writes must not wedge the rotation
                print("ERROR: ckpt is not there?")
            latest = latest[1:]
        latest += [model_path]
        ckpts["latest"] = latest
        ckpts["current"] = model_path
        out = os.path.join(self.save_path, "weights_" + model_path)
        torch.save(payload, out)
        with open(self.ckpt_path, "w") as f:
            f.write(json.dumps(ckpts, indent=2))
        return out

    def read_latest_checkpoint(self):
        self.flush()  # a just-scheduled async write must be visible to readers
        if not os.path.exists(self.ckpt_path):
            print(f"[!] No checkpoint found in {self.save_path}")
            return False
        with open(self.ckpt_path, "r") as f:
            ckpts = json.load(f)
        return ckpts["current"]

    def load_weights(self):
        """(payload, {'step'}) of the current checkpoint, or None without one."""
        curr = self.read_latest_checkpoint()
        if curr is False:
            return None
        path = os.path.join(self.save_path, "weights_" + curr)
        if _is_npz(path):
            raise NotImplementedError(
                f"{path} was written by the JAX trainer, whose optimizer state the port "
                "does not read: load its weights with --g_pretrained_ckpt / "
                "--d_pretrained_ckpt instead")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        print("[*] Loaded weights")
        return payload, {"step": int(payload.get("step", 0))}
