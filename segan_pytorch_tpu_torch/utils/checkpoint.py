"""Generator and Discriminator checkpoints: the counterpart of the torch and npz loaders
and of the ``Saver`` of ``segan_pytorch_tpu/utils/checkpoint.py``.

The port's models have the upstream torch state_dict names and layouts, so a
reference-format ``.ckpt`` (``torch.save({'step', 'state_dict'})``, which upstream
and the JAX ``export_torch_generator`` / ``export_torch_discriminator`` write) loads
with ``strict=True`` once legacy key names are migrated. A checkpoint that the JAX
trainer wrote (an npz pytree) is converted with ``generator_state_from_jax`` /
``discriminator_state_from_jax``, and its optax state with ``optimizer_state_from_jax``.
The other way, ``read_torch_state`` with ``generator_tree_from_torch`` /
``discriminator_tree_from_torch`` turns a torch checkpoint into the JAX variables tree
(the JAX ``load_torch_generator`` / ``load_torch_discriminator``), which ``save_pytree``
writes in the JAX npz format; ``export_torch`` writes a bridged state in the key order
of the JAX export (both used by ``weight_converter``).

``Saver`` keeps the reference's rotating JSON index and file names; its payloads are
reference-format torch files with the optimizer state beside the weights, so the JAX
``load_torch_generator`` and ``purge_ckpts.py`` read what the port's trainer writes. It
reads the JAX trainer's payloads too, and ``load_payload`` loads either kind into a
model and its optimizer, so ``--resume`` continues a run directory of either trainer.
"""
from __future__ import annotations

import json
import os
import re
import threading
import zipfile
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models import modules as M


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


def _read_npz(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Every leaf of an npz pytree, flattened to 'a/b/c' keys, and its JSON meta ({}
    without one)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__meta__"}
        meta = (json.loads(bytes(data["__meta__"].tobytes()).decode())
                if "__meta__" in data.files else {})
    return flat, meta


def _subtree(flat: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _read_npz_state(path: str) -> Dict[str, np.ndarray]:
    """The model variables of an npz pytree, flattened to 'a/b/c' keys: those under
    'state_dict/' when the JAX trainer's Saver wrote it (which stores the optimizer
    state beside them, under 'optimizer/'), else every leaf."""
    flat, _ = _read_npz(path)
    if any(k.startswith("state_dict/") for k in flat):
        return _subtree(flat, "state_dict/")
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


def _optimizer_payload(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's state_dict on the CPU, with ``capturable`` off in every group: it
    says how a CUDA graph of the step runs (``models/multistep.py``), not what the state
    is, so the payload loads into an eager engine on any device as one written by eager
    steps does (the step counts are then host tensors, as eager steps keep them)."""
    payload = _to_cpu(optimizer.state_dict())
    for group in payload["param_groups"]:
        if "capturable" in group:
            group["capturable"] = False
    return payload


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


def discriminator_bridge(D: torch.nn.Module) -> Callable[[Mapping[str, np.ndarray]],
                                                          Dict[str, torch.Tensor]]:
    """``discriminator_state_from_jax`` with D's own flatten shape."""
    last_fmaps = D.enc_blocks[-1].act.weight.shape[0]
    return lambda flat: discriminator_state_from_jax(flat, D.pool_slen, last_fmaps)


def load_discriminator(D: torch.nn.Module, path: str) -> None:
    """Load a checkpoint into D strictly: every key present, none extra."""
    last_fmaps = D.enc_blocks[-1].act.weight.shape[0]
    D.load_state_dict(read_discriminator_state(path, D.pool_slen, last_fmaps), strict=True)


def save_discriminator(D: torch.nn.Module, path: str, step: int = 0) -> None:
    """Write D as a reference-format torch checkpoint ({'step', 'state_dict'}), which
    upstream's loader and the JAX ``load_torch_discriminator`` read."""
    _save_model(D, path, step)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _collections(flat: Mapping[str, np.ndarray]):
    """[(collection, path parts, value)] of flattened JAX variables (a leaf without a
    collection is a param), and the set of module paths ('enc_blocks_0/conv', 'fc_3')
    that carry spectral-norm state."""
    leaves = []
    for path, v in flat.items():
        parts = path.split("/")
        coll = "params"
        if parts[0] in ("params", "batch_stats", "spectral"):
            coll, parts = parts[0], parts[1:]
        leaves.append((coll, parts, np.asarray(v)))
    normed = {"/".join(parts[:-1]) for coll, parts, _ in leaves if coll == "spectral"}
    return leaves, normed


def _jax_weight(flat: Mapping[str, np.ndarray], module: str) -> np.ndarray:
    """The JAX param 'weight' of `module`, with or without the 'params/' prefix."""
    return np.asarray(flat.get(f"params/{module}/weight", flat.get(f"{module}/weight")))


def _snorm_v_from_jax(v: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Spectral norm's v from the JAX column order into torch's: a Conv1d's JAX weight
    (K, Cin, Cout) is viewed with columns (K, Cin), torch's (Cout, Cin, K) with columns
    (Cin, K) (the JAX export's ``_snorm_v_to_torch``); the columns of Linears and PReLUs
    agree (a deconv's too, which callers do not pass here). sigma does not depend on the
    order, but a loaded u, v pair must match its W."""
    v = np.reshape(v, -1)
    if w.ndim == 3:
        kw, cin, _ = w.shape
        return v.reshape(kw, cin).T.reshape(-1)
    return v


def generator_state_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Turn the JAX Generator's variables, flattened to 'a/b/c' numpy leaves (with or
    without a leading 'params/'), into the port's state_dict.

    conv (K, Cin, Cout) -> (Cout, Cin, K); deconv (K, Cin, Cout) -> (Cin, Cout, K);
    alpha skips (C,) -> (1, C, 1); PReLU slopes and biases unchanged. A spectrally
    normalised (snorm) layer's weight becomes 'weight_orig', and its 'spectral' u and v
    'weight_u' and 'weight_v' (a conv's v reordered, ``_snorm_v_from_jax``). A bnorm
    generator's BatchNorm leaves keep their names ('norm.weight' and 'norm.bias' from
    'params', 'norm.running_mean' and 'norm.running_var' from 'batch_stats'), and every
    norm gets ``num_batches_tracked`` 0, as the JAX export writes it."""
    leaves, normed = _collections(flat)
    out: Dict[str, torch.Tensor] = {}
    for coll, parts, v in leaves:
        blk, rest = parts[0], parts[1:]
        if blk.startswith(("enc_blocks_", "dec_blocks_")):
            group, idx = blk.rsplit("_", 1)
            sub, leaf = rest
            if coll == "spectral":  # a deconv's v has torch's column order already
                if leaf == "weight_v" and sub == "conv":
                    v = _snorm_v_from_jax(v, _jax_weight(flat, f"{blk}/{sub}"))
            elif leaf == "weight" and sub in ("conv", "deconv"):
                v = np.transpose(v, (2, 1, 0) if sub == "conv" else (1, 2, 0))
                if f"{blk}/{sub}" in normed:
                    leaf = "weight_orig"
            out[f"{group}.{idx}.{sub}.{leaf}"] = _tensor(v)
            if sub == "norm" and leaf == "weight":
                out[f"{group}.{idx}.norm.num_batches_tracked"] = torch.tensor(0)
        elif blk.startswith("alpha_") and rest == ["skip_k"]:
            out[f"{blk}.skip_k"] = _tensor(np.reshape(v, (1, -1, 1)))
        elif blk.startswith("alpha_") and rest[0] == "skip_k" and coll == "params":
            if rest[1] == "weight":
                v = np.transpose(v, (2, 1, 0))
            out[f"{blk}.skip_k.{rest[1]}"] = _tensor(v)
        else:
            raise KeyError(f"unexpected generator variable {coll}/{'/'.join(parts)}")
    return out


def module_state_from_jax(module: torch.nn.Module,
                          flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The state_dict of any port module (the blocks of ``models/modules.py``) from its
    JAX counterpart's variables, flattened to 'a/b/c' leaves ('params/', 'batch_stats/'
    and 'spectral/' collections; a leaf without one is a param). Each port name has one
    JAX path: a list index joins its parent with '_' ('filts.0.filt.weight' ->
    'filts_0/filt/weight'), and 'weight_orig' is the JAX param 'weight'. Layouts follow
    the owning layer: a Conv1d's weight (K, Cin, Cout) -> (Cout, Cin, K) and its
    spectral v reordered (``_snorm_v_from_jax``), a ConvTranspose1d's -> (Cin, Cout, K),
    a Linear's (in, out) -> (out, in); every other leaf as it is, in the port's shape.
    BatchNorm's ``num_batches_tracked`` is 0. Raises KeyError on a missing leaf."""
    leaves, _ = _collections(flat)
    jax = {(coll, "/".join(parts)): v for coll, parts, v in leaves}
    owners = dict(module.named_modules())
    out: Dict[str, torch.Tensor] = {}
    for name, ref in module.state_dict().items():
        owner_name, _, leaf = name.rpartition(".")
        owner = owners[owner_name]
        if leaf == "num_batches_tracked":
            out[name] = torch.tensor(0)
            continue
        path = re.sub(r"\.(\d+)", r"_\1", owner_name).replace(".", "/")
        path = f"{path}/" if path else ""
        if leaf in ("weight_u", "weight_v"):
            v = jax[("spectral", path + leaf)]
            if leaf == "weight_v" and isinstance(owner, M.Conv1d):
                v = _snorm_v_from_jax(v, jax[("params", path + "weight")])
        elif leaf in ("running_mean", "running_var"):
            v = jax[("batch_stats", path + leaf)]
        else:
            v = jax[("params", path + ("weight" if leaf == "weight_orig" else leaf))]
            if leaf in ("weight", "weight_orig"):
                v = _weight_from_jax(v, next((k for t, k in _LAYOUTS if isinstance(owner, t)),
                                             None))
        out[name] = _tensor(np.reshape(v, tuple(ref.shape)))
    return out


# the JAX -> torch weight layout of each kind of layer
_LAYOUTS = ((M.Conv1d, "conv"), (M.ConvTranspose1d, "deconv"), (M.Linear, "linear"))


def _weight_from_jax(v: np.ndarray, kind: Optional[str]) -> np.ndarray:
    """A JAX weight in the port's layout: a conv's (K, Cin, Cout) -> (Cout, Cin, K), a
    transposed conv's -> (Cin, Cout, K), a Linear's (in, out) -> (out, in); any other
    (a PReLU slope) as it is."""
    if kind == "conv":
        return np.transpose(v, (2, 1, 0))
    if kind == "deconv":
        return np.transpose(v, (1, 2, 0))
    return np.transpose(v) if kind == "linear" else v


_G1D_LISTS = re.compile(r"^(gen_enc|gen_dec|convs|acts|filts)_(\d+)$")
_LSTM_GATES = ("i", "f", "g", "o")  # flax's OptimizedLSTMCell and torch's nn.LSTM alike


def _g1d_lstm_from_jax(cells: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The bidirectional LSTM 'rnn_core' from flax's two ``OptimizedLSTMCell``s: per
    direction (cell_fwd -> '_l0', cell_bwd -> '_l0_reverse') the input kernels 'i<gate>'
    (C, H, no bias) stacked into weight_ih (4H, C), the hidden kernels 'h<gate>' (H, H)
    into weight_hh (4H, H), their biases into bias_ih, and bias_hh zero."""
    out = {}
    for cell, suffix in (("cell_fwd", "_l0"), ("cell_bwd", "_l0_reverse")):
        def stack(kind, leaf):
            return np.concatenate([cells[f"{cell}/{kind}{g}/{leaf}"] for g in _LSTM_GATES],
                                  axis=-1)

        bias = stack("h", "bias")
        out[f"rnn_core.weight_ih{suffix}"] = _tensor(stack("i", "kernel").T)
        out[f"rnn_core.weight_hh{suffix}"] = _tensor(stack("h", "kernel").T)
        out[f"rnn_core.bias_ih{suffix}"] = _tensor(bias)
        out[f"rnn_core.bias_hh{suffix}"] = _tensor(np.zeros_like(bias))
    return out


def generator1d_state_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Turn the JAX ``Generator1D``'s variables, flattened to 'a/b/c' numpy leaves
    ('params/' and 'spectral/' collections; a leaf without one is a param), into the
    state_dict of the port's ``models/generator1d.py`` ``Generator1D``.

    A list index joins its parent with a dot ('gen_enc_0/conv/convs_1/weight' ->
    'gen_enc.0.conv.convs.1.weight', 'comb_net/filts_2' -> 'comb_net.filts.2'); the alpha
    skips 'alpha_<i>' keep their names. Layouts as ``module_state_from_jax`` gives them:
    conv weights (K, Cin, Cout) -> (Cout, Cin, K) ('deconv' -> (Cin, Cout, K)), the
    comb net's Linear 'W' (in, out) -> (out, in), an alpha skip's scale (C,) -> (1, C, 1);
    a snorm layer's weight becomes 'weight_orig' and its 'spectral' u and v 'weight_u' and
    'weight_v' (a conv's v reordered, ``_snorm_v_from_jax``); the LSTM as
    ``_g1d_lstm_from_jax``. Raises KeyError on a leaf no port module has."""
    leaves, normed = _collections(flat)
    out: Dict[str, torch.Tensor] = {}
    lstm = {}
    for coll, parts, v in leaves:
        module, leaf = "/".join(parts[:-1]), parts[-1]
        if parts[0] == "rnn_core" and coll == "params":
            lstm["/".join(parts[1:])] = v
            continue
        if not parts[0].startswith(("gen_enc_", "gen_dec_", "alpha_", "comb_net",
                                    "out_gate", "out_filter")):
            raise KeyError(f"unexpected Generator1D variable {coll}/{'/'.join(parts)}")
        name = ".".join(_G1D_LISTS.sub(r"\1.\2", p) for p in parts[:-1])
        if coll == "spectral":
            if leaf == "weight_v" and not module.endswith("deconv"):
                v = _snorm_v_from_jax(v, _jax_weight(flat, module))
        elif parts[0].startswith("alpha_") and parts[1:] == ["skip_k"]:
            v = np.reshape(v, (1, -1, 1))
        elif leaf == "weight":
            kind = ("deconv" if module.endswith("deconv") else
                    "conv" if v.ndim == 3 else "linear" if v.ndim == 2 else None)
            v = _weight_from_jax(v, kind)
            if module in normed:
                leaf = "weight_orig"
        out[f"{name}.{leaf}" if name else leaf] = _tensor(v)
    if lstm:
        out.update(_g1d_lstm_from_jax(lstm))
    return out


def _d_module_name(module: str) -> str:
    """The port's name of a JAX D module: 'enc_blocks_0/conv' -> 'enc_blocks.0.conv',
    'fc_3' -> 'fc.3', 'mlp_1' -> 'mlp.1'; 'fc' and 'pool_conv' as they are."""
    parts = module.split("/")
    if parts[0].startswith(("enc_blocks_", "fc_", "mlp_")):
        parts[0] = ".".join(parts[0].rsplit("_", 1))
    return ".".join(parts)


def discriminator_state_from_jax(flat: Mapping[str, np.ndarray], pool_slen: int,
                                 last_fmaps: int) -> Dict[str, torch.Tensor]:
    """Turn the JAX Discriminator's variables, flattened to 'a/b/c' numpy leaves ('params/',
    'batch_stats/' and 'spectral/' collections; a leaf without a collection is a param),
    into the port's state_dict: the inverse of the JAX ``load_torch_discriminator``.

    conv (K, Cin, Cout) -> (Cout, Cin, K); Linear (in, out) -> (out, in), fc_0's input
    reordered from the JAX flatten (T, C) to upstream's (C, T) with C = ``last_fmaps``,
    T = ``pool_slen``; PReLU slopes, biases, BatchNorm leaves and the SincConv front
    end's 'sinc_conv/filt_b1' and 'filt_band' unchanged. Every
    BatchNorm gets ``num_batches_tracked`` 0, as the JAX export writes it. A spectrally
    normalised layer's weight becomes 'weight_orig' and its u and v 'weight_u' and
    'weight_v', v reordered as its weight's columns are (a conv's (K, Cin) -> (Cin, K),
    fc_0's (T, C) -> (C, T))."""
    leaves, normed = _collections(flat)
    out: Dict[str, torch.Tensor] = {}
    for coll, parts, v in leaves:
        module, leaf = "/".join(parts[:-1]), parts[-1]
        if not parts[0].startswith(("enc_blocks_", "fc", "mlp_", "pool_conv",
                                    "sinc_conv")):
            raise KeyError(f"unexpected discriminator variable {coll}/{'/'.join(parts)}")
        name = _d_module_name(module)
        if coll == "spectral":
            if leaf == "weight_v":
                v = np.reshape(v, -1)
                if module == "fc_0":  # (T, C) -> (C, T), as fc.0's weight columns
                    v = v.reshape(pool_slen, last_fmaps).T.reshape(-1)
                else:
                    v = _snorm_v_from_jax(v, _jax_weight(flat, module))
        elif leaf == "weight" and v.ndim == 3:  # conv (K, Cin, Cout)
            v = np.transpose(v, (2, 1, 0))
        elif leaf == "weight" and v.ndim == 2:  # Linear (in, out)
            v = v.T
            if module == "fc_0":  # (256, T*C) -> (256, T, C) -> (256, C, T)
                v = np.transpose(v.reshape(v.shape[0], pool_slen, last_fmaps),
                                 (0, 2, 1)).reshape(v.shape[0], -1)
        if coll == "params" and leaf == "weight" and module in normed:
            leaf = "weight_orig"
        out[f"{name}.{leaf}"] = _tensor(v)
        if name.endswith(".norm") and leaf == "weight":
            out[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return out


# -- the JAX package's npz pytrees, and torch checkpoints turned into them ---------------
def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays flattened to {'a/b/c': leaf}, in the dicts' order."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """The inverse of ``flatten_tree``."""
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_pytree(path: str, tree, meta: Optional[dict] = None) -> None:
    """``np.savez`` of the flattened tree, the meta as JSON bytes under '__meta__' (numpy
    appends '.npz' to a path without it)."""
    flat = flatten_tree(tree)
    if meta is not None:
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_pytree(path: str) -> Tuple[dict, Optional[dict]]:
    """(tree, meta) of a ``save_pytree`` file; meta None without one."""
    flat, meta = _read_npz(path)
    return unflatten_tree(flat), meta or None


def read_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state_dict as numpy arrays, in the names the JAX converters
    read: legacy 'gen_enc'/'gen_dec' migrated (``_migrate_key``), and spectral norm's
    'weight_orig' called 'weight' (its 'weight_u'/'weight_v' stay); leaves that are not
    tensors are dropped."""
    st = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in st:
        st = st["state_dict"]
    out = {}
    for k, v in st.items():
        k = _migrate_key(k)
        if k.endswith(".weight_orig"):
            k = k[: -len("_orig")]
        if torch.is_tensor(v):
            out[k] = v.detach().cpu().numpy()
    return out


def _snorm_v_to_jax(v: np.ndarray, kind: str, w_shape) -> np.ndarray:
    """The inverse of ``_snorm_v_from_jax``: a Conv1d's v from torch's columns (Cin, K)
    to the JAX (K, Cin); the other layers' columns agree."""
    v = np.asarray(v, np.float32).reshape(-1)
    if kind == "conv":
        _, cin, kw = w_shape
        return v.reshape(cin, kw).T.reshape(-1)
    return v


def _put(root: dict, path, arr) -> None:
    node = root
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(arr, np.float32)


def _tree(params: dict, batch_stats: dict, spectral: dict) -> dict:
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    if spectral:
        out["spectral"] = spectral
    return out


def generator_tree_from_torch(st: Mapping[str, np.ndarray]) -> dict:
    """A G state from ``read_torch_state`` as the JAX Generator's variables {'params'[,
    'batch_stats'][, 'spectral']}: the JAX ``load_torch_generator``. conv (Cout, Cin, K)
    -> (K, Cin, Cout), deconv (Cin, Cout, K) -> (K, Cin, Cout), alpha skips (1, C, 1) ->
    (C,); a BatchNorm's running statistics go to 'batch_stats' and its
    ``num_batches_tracked`` is dropped; u and v go to 'spectral', a conv's v reordered."""
    params: dict = {}
    batch_stats: dict = {}
    spectral: dict = {}
    for k, v in st.items():
        parts = k.split(".")
        if parts[0] in ("enc_blocks", "dec_blocks"):
            blk, sub, leaf = f"{parts[0]}_{parts[1]}", parts[2], parts[3]
            if sub == "conv" and leaf == "weight":
                _put(params, [blk, "conv", "weight"], np.transpose(v, (2, 1, 0)))
            elif sub == "deconv" and leaf == "weight":
                _put(params, [blk, "deconv", "weight"], np.transpose(v, (2, 0, 1)))
            elif sub in ("conv", "deconv") and leaf == "bias":
                _put(params, [blk, sub, "bias"], v)
            elif sub in ("conv", "deconv") and leaf == "weight_u":
                _put(spectral, [blk, sub, "weight_u"], v)
            elif sub in ("conv", "deconv") and leaf == "weight_v":
                w_shape = st[f"{parts[0]}.{parts[1]}.{sub}.weight"].shape
                _put(spectral, [blk, sub, "weight_v"], _snorm_v_to_jax(v, sub, w_shape))
            elif sub == "act":
                _put(params, [blk, "act", "weight"], v)
            elif sub == "norm" and leaf in ("running_mean", "running_var"):
                _put(batch_stats, [blk, "norm", leaf], v)
            elif sub == "norm" and leaf in ("weight", "bias"):
                _put(params, [blk, "norm", leaf], v)
        elif parts[0].startswith("alpha_"):
            if parts[1:] == ["skip_k"]:
                _put(params, [parts[0], "skip_k"], np.reshape(v, (-1,)))
            elif parts[1] == "skip_k":  # a conv skip
                _put(params, [parts[0], "skip_k", parts[2]],
                     np.transpose(v, (2, 1, 0)) if parts[2] == "weight" else v)
    return _tree(params, batch_stats, spectral)


def discriminator_tree_from_torch(st: Mapping[str, np.ndarray], pool_slen: int,
                                  last_fmaps: int) -> dict:
    """A D state from ``read_torch_state`` as the JAX Discriminator's variables: the
    JAX ``load_torch_discriminator``, which this also follows for the heads (fc.0's
    input reordered from upstream's flatten (C, T) to the JAX (T, C), with C =
    `last_fmaps`, T = `pool_slen`). One difference: a sinc D's filter bank,
    'sinc_conv.filt_b1' and 'filt_band', goes to 'params/sinc_conv' as it is, where the
    JAX converter drops it."""
    params: dict = {}
    batch_stats: dict = {}
    spectral: dict = {}
    for k, v in st.items():
        parts = k.split(".")
        if parts[0] == "enc_blocks":
            blk, sub, leaf = f"enc_blocks_{parts[1]}", parts[2], parts[3]
            if sub == "conv" and leaf == "weight":
                _put(params, [blk, "conv", "weight"], np.transpose(v, (2, 1, 0)))
            elif sub == "conv" and leaf == "bias":
                _put(params, [blk, "conv", "bias"], v)
            elif sub == "conv" and leaf == "weight_u":
                _put(spectral, [blk, "conv", "weight_u"], v)
            elif sub == "conv" and leaf == "weight_v":
                w_shape = st[f"enc_blocks.{parts[1]}.conv.weight"].shape
                _put(spectral, [blk, "conv", "weight_v"], _snorm_v_to_jax(v, "conv", w_shape))
            elif sub == "act":
                _put(params, [blk, "act", "weight"], v)
            elif sub == "norm" and leaf in ("weight", "bias"):
                _put(params, [blk, "norm", leaf], v)
            elif sub == "norm" and leaf in ("running_mean", "running_var"):
                _put(batch_stats, [blk, "norm", leaf], v)
        elif parts[0] == "sinc_conv":
            _put(params, ["sinc_conv", parts[1]], v)
        elif parts[0] == "fc" and len(parts) == 3:  # the 'none' head: Linear, PReLU, ...
            idx, leaf, name = int(parts[1]), parts[2], f"fc_{parts[1]}"
            if leaf == "weight_u":
                _put(spectral, [name, "weight_u"], v)
            elif leaf == "weight_v":
                vv = np.asarray(v, np.float32).reshape(-1)
                if idx == 0:  # fc.0's columns (C, T) -> (T, C)
                    vv = vv.reshape(last_fmaps, pool_slen).T.reshape(-1)
                _put(spectral, [name, "weight_v"], vv)
            elif idx in (1, 3):  # PReLU
                _put(params, [name, "weight"], v)
            elif leaf == "weight":
                w = np.asarray(v)
                if idx == 0:  # (256, C*T) -> (256, T*C)
                    w = np.transpose(w.reshape(w.shape[0], last_fmaps, pool_slen),
                                     (0, 2, 1)).reshape(w.shape[0], -1)
                _put(params, [name, "weight"], w.T)
            else:
                _put(params, [name, "bias"], v)
        elif parts[0] == "fc":  # one Linear (the conv, gmax and gavg heads)
            if parts[1] == "weight":
                _put(params, ["fc", "weight"], np.asarray(v).T)
            elif parts[1] in ("weight_u", "weight_v"):
                _put(spectral, ["fc", parts[1]], v)
            else:
                _put(params, ["fc", "bias"], v)
        elif parts[0] == "mlp":  # Conv1d, PReLU, Conv1d
            idx, leaf, name = int(parts[1]), parts[2], f"mlp_{parts[1]}"
            if leaf == "weight_u":
                _put(spectral, [name, "weight_u"], v)
            elif leaf == "weight_v":
                w_shape = st[f"mlp.{idx}.weight"].shape
                _put(spectral, [name, "weight_v"],
                     _snorm_v_to_jax(v, "conv" if len(w_shape) == 3 else "linear", w_shape))
            elif idx == 1:
                _put(params, [name, "weight"], v)
            elif leaf == "weight":
                _put(params, [name, "weight"], np.transpose(v, (2, 1, 0)))
            else:
                _put(params, [name, "bias"], v)
        elif parts[0] == "pool_conv":
            if parts[1] == "weight":
                _put(params, ["pool_conv", "weight"], np.transpose(v, (2, 1, 0)))
            elif parts[1] == "weight_u":
                _put(spectral, ["pool_conv", "weight_u"], v)
            elif parts[1] == "weight_v":
                _put(spectral, ["pool_conv", "weight_v"],
                     _snorm_v_to_jax(v, "conv", st["pool_conv.weight"].shape))
            else:
                _put(params, ["pool_conv", "bias"], v)
    return _tree(params, batch_stats, spectral)


# the order in which the JAX export writes a block's leaves, and a model's groups
_LEAF_ORDER = {"weight": 0, "weight_orig": 0, "weight_u": 1, "weight_v": 2, "bias": 3,
               "running_mean": 4, "running_var": 5, "num_batches_tracked": 6}
_GROUP_ORDER = ("sinc_conv", "enc_blocks", "dec_blocks", "alpha", "pool_conv", "fc.i",
                "fc", "mlp")


def _export_key(k: str):
    """Sort key of a state_dict name in the JAX export's order: the groups of
    `_GROUP_ORDER` (a sinc D's bank first, as the port's D holds it; 'fc.i' the layers
    of the 'none' head, 'fc' the one Linear of the others), blocks by index, in a block
    its conv, PReLU, then norm, each leaf by `_LEAF_ORDER`."""
    parts = k.split(".")
    stem, _, num = parts[0].rpartition("_")
    if not num.isdigit():  # no '_<i>' suffix: the index is the second part, if any
        stem, num = parts[0], parts[1] if parts[1].isdigit() else "0"
    if stem == "fc" and len(parts) == 3:
        stem = "fc.i"
    sub = {"act": 1, "norm": 2}.get(parts[2], 0) if len(parts) == 4 else 0
    return _GROUP_ORDER.index(stem), int(num), sub, _LEAF_ORDER.get(parts[-1], 0)


def export_torch(state: Dict[str, torch.Tensor], path: str, step: int = 0) -> None:
    """``torch.save({'step', 'state_dict'})`` of a state from ``generator_state_from_jax``
    or ``discriminator_state_from_jax``, its keys in the order the JAX
    ``export_torch_generator`` / ``export_torch_discriminator`` write them (upstream's
    partial load drops the last keys of a D: fc.4's)."""
    ordered = {k: state[k] for k in sorted(state, key=_export_key)}
    torch.save({"step": int(step), "state_dict": ordered}, path)


# the optax slots of each torch optimizer's per-parameter state: rmsprop(eps_in_sqrt=
# False)'s nu is RMSprop's square_avg; Adam's mu and nu are exp_avg and exp_avg_sq
OPTAX_SLOTS = {torch.optim.RMSprop: {"square_avg": "nu"},
               torch.optim.Adam: {"exp_avg": "mu", "exp_avg_sq": "nu"}}


def optimizer_state_from_jax(opt_flat: Mapping[str, np.ndarray],
                             optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                             state_flat: Mapping[str, np.ndarray],
                             state_from_jax: Callable, step: int) -> dict:
    """A state_dict for `optimizer` (over `model`'s parameters) from the JAX trainer's
    optax state: its flax state dict flattened to 'a/b/c' keys ('0/nu/enc_blocks_0/conv/
    weight', '0/count'; empty nodes drop out of the npz). Each slot's leaves hold one
    array per parameter in the JAX layout, so they go through the model's bridge
    (`state_from_jax`) as the parameters do, with the 'spectral' leaves of `state_flat`
    beside them so that a spectrally normalised weight's slot lands on 'weight_orig'.
    Adam's count becomes every parameter's step; RMSprop, whose optax state has no
    count and whose update reads none, takes `step`. Raises when the slots are not the
    optimizer's or a parameter has none."""
    kind = next((k for k in OPTAX_SLOTS if isinstance(optimizer, k)), None)
    if kind is None:
        raise TypeError(f"no optax counterpart for {type(optimizer).__name__}")
    slots: Dict[str, Dict[str, np.ndarray]] = {}
    count = None
    for key, v in opt_flat.items():
        parts = key.split("/")
        i = next((j for j, p in enumerate(parts) if p in ("mu", "nu", "count")), None)
        if i is None:
            raise KeyError(f"unexpected optimizer leaf {key}")
        if parts[i] == "count":
            count = int(np.asarray(v))
        else:
            slots.setdefault(parts[i], {})["/".join(parts[i + 1:])] = v
    want = OPTAX_SLOTS[kind]
    if set(slots) != set(want.values()):
        raise ValueError(f"the JAX optimizer state has slots {sorted(slots)}, "
                         f"{kind.__name__} needs {sorted(want.values())}")
    spectral = {k: v for k, v in state_flat.items() if k.startswith("spectral/")}
    names = {id(p): n for n, p in model.named_parameters()}
    mapped = {}
    for slot, leaves in slots.items():
        out = state_from_jax({**{f"params/{k}": v for k, v in leaves.items()}, **spectral})
        mapped[slot] = {n: out[n] for n in names.values() if n in out}
        missing = set(names.values()) - set(mapped[slot])
        if missing:
            raise KeyError(f"no '{slot}' state for {sorted(missing)}")
    payload = optimizer.state_dict()
    payload["state"] = {}
    i = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            st = {"step": torch.tensor(float(step if count is None else count))}
            st.update({k: mapped[slot][name] for k, slot in want.items()})
            payload["state"][i] = st
            i += 1
    return payload


def load_payload(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
                 payload: dict, state_from_jax: Callable) -> None:
    """Load a ``Saver`` payload into `model` (strictly) and `optimizer` (when the payload
    has its state): the port's own as it is, the JAX trainer's through `state_from_jax`
    (``generator_state_from_jax``, ``discriminator_bridge(D)``) and
    ``optimizer_state_from_jax``. ``load_state_dict`` puts the step counts on the card
    when the optimizer is capturable."""
    if payload.get("format") != "jax":
        model.load_state_dict(payload["state_dict"], strict=True)
        if optimizer is not None and "optimizer" in payload:
            optimizer.load_state_dict(payload["optimizer"])
        return
    state = payload["state_dict"]
    model.load_state_dict(state_from_jax(state), strict=True)
    if optimizer is not None and payload.get("optimizer"):
        optimizer.load_state_dict(optimizer_state_from_jax(
            payload["optimizer"], optimizer, model, state, state_from_jax,
            payload["step"]))


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
            payload["optimizer"] = _optimizer_payload(optimizer)
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
        """(payload, {'step'}) of the current checkpoint, or None without one. A payload
        that the JAX trainer wrote (an npz) comes as {'format': 'jax', 'step', 'state_dict',
        'optimizer'}, its variables and optax state flattened to 'a/b/c' numpy leaves
        in the JAX layout, for ``load_payload``; its step is the meta 'step'."""
        curr = self.read_latest_checkpoint()
        if curr is False:
            return None
        path = os.path.join(self.save_path, "weights_" + curr)
        if _is_npz(path):
            flat, meta = _read_npz(path)
            step = int(meta.get("step", 0))
            payload = {"format": "jax", "step": step,
                       "state_dict": _subtree(flat, "state_dict/"),
                       "optimizer": _subtree(flat, "optimizer/")}
            print("[*] Loaded weights (written by the JAX trainer)")
            return payload, {"step": step}
        payload = torch.load(path, map_location="cpu", weights_only=True)
        print("[*] Loaded weights")
        return payload, {"step": int(payload.get("step", 0))}
