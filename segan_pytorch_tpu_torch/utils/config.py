"""Typed configuration: a copy of ``segan_pytorch_tpu/utils/config.py``.

Copied rather than imported because importing anything under ``segan_pytorch_tpu``
imports jax, which the CUDA machine does not have. ``tests/test_torch_config.py``
pins this copy to the original: same fields, same defaults, same ``train.opts``
parsing (including the legacy boolean ``l1_loss``).

The TPU lowering knobs (``conv_grad``, ``edge_conv``, ``bn_impl``, ...), ``dp``/``mp``
and ``use_pallas`` are read from ``train.opts`` and ignored by the port: on a CUDA
device the generator encoder always runs the hand-written kernel.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


def _default_fmaps() -> List[int]:
    return [64, 128, 256, 512, 1024]


def _default_poolings() -> List[int]:
    return [4, 4, 4, 4, 4]


@dataclass
class SEGANConfig:
    """All training/inference options, field for field as in the JAX package."""

    # paths / io
    save_path: str = "seganv1_ckpt"
    d_pretrained_ckpt: Optional[str] = None
    g_pretrained_ckpt: Optional[str] = None
    cache_dir: str = "data_cache"
    clean_trainset: str = "data/clean_trainset"
    noisy_trainset: str = "data/noisy_trainset"
    clean_valset: Optional[str] = None
    noisy_valset: Optional[str] = None
    h5_data_root: Optional[str] = None
    h5: bool = False

    # data
    data_stride: float = 0.5
    seed: int = 111
    epoch: int = 100
    patience: int = 100
    batch_size: int = 100
    save_freq: int = 50
    slice_size: int = 16384

    # optimization
    opt: str = "rmsprop"
    l1_dec_epoch: int = 100
    l1_weight: float = 100.0
    l1_dec_step: float = 1e-5
    g_lr: float = 5e-5
    d_lr: float = 5e-5
    preemph: float = 0.95
    max_samples: Optional[int] = None
    eval_workers: int = 2
    slice_workers: int = 1
    num_workers: int = 1
    no_cuda: bool = False
    random_scale: List[float] = field(default_factory=lambda: [1])
    no_train_gen: bool = False
    preemph_norm: bool = False

    # model family
    wsegan: bool = False
    aewsegan: bool = False
    vanilla_gan: bool = False
    no_bias: bool = False
    n_fft: int = 2048
    reg_loss: str = "l1_loss"  # 'l1_loss' | 'mse_loss'

    # G skip connections
    skip_merge: str = "concat"
    skip_type: str = "alpha"  # alpha | conv | constant
    skip_init: str = "one"  # one | zero | randn
    skip_kwidth: int = 11

    # G architecture
    gkwidth: int = 31
    genc_fmaps: List[int] = field(default_factory=_default_fmaps)
    genc_poolings: List[int] = field(default_factory=_default_poolings)
    z_dim: int = 1024
    gdec_fmaps: Optional[List[int]] = None
    gdec_poolings: Optional[List[int]] = None
    gdec_kwidth: Optional[int] = None
    gnorm_type: Optional[str] = None
    no_z: bool = False
    no_skip: bool = False
    pow_weight: float = 0.001
    misalign_pair: bool = False
    interf_pair: bool = False

    # D architecture
    denc_fmaps: List[int] = field(default_factory=_default_fmaps)
    dpool_type: str = "none"  # none | conv | gmax | gavg | mlp
    dpool_slen: int = 16
    dkwidth: Optional[int] = None
    denc_poolings: List[int] = field(default_factory=_default_poolings)
    dnorm_type: Optional[str] = "bnorm"
    phase_shift: Optional[int] = 5
    sinc_conv: bool = False

    # derived; None = derive from no_bias in __post_init__
    bias: Optional[bool] = None

    # --- extensions of the JAX package (not in the upstream argparse) ---
    dp: int = 1
    mp: int = 1
    # 'float32' or 'bfloat16': dtype of the network's convs; params stay fp32
    compute_dtype: str = "float32"
    bn_stats: str = "global"
    legacy_l1_loss: Optional[bool] = None
    deconv_impl: Optional[str] = None
    # TPU lowering knobs: kept so train.opts files round-trip; unused by the port
    conv_grad: Optional[str] = None
    edge_conv: Optional[str] = None
    bn_impl: Optional[str] = None
    snorm_impl: Optional[str] = None
    fuse_d: Optional[bool] = None
    ws_fuse_d: Optional[bool] = None
    stft_precision: Optional[str] = None
    stft_method: Optional[str] = None
    roll_impl: Optional[str] = None
    use_pallas: bool = False
    resume: bool = False
    eoe_save_every: int = 1
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    profile: bool = False
    eval_max_samples: int = 1
    noises_dir: Optional[str] = None
    snr_levels: List[int] = field(default_factory=lambda: [0, 5, 10])
    shuffle_buffer: int = 0
    shuffle_buffer_mode: str = "sharded"
    steps_per_call: int = 1
    loader_dtype: Optional[str] = None
    io_threads: int = 0

    def __post_init__(self):
        if self.bias is None:
            self.bias = not self.no_bias

    @classmethod
    def from_dict(cls, d: dict) -> "SEGANConfig":
        """Build from a (possibly legacy) train.opts dict, tolerating unknown/missing keys."""
        d = dict(d)
        # legacy key: boolean l1_loss instead of reg_loss
        if "reg_loss" not in d and "l1_loss" in d:
            d["legacy_l1_loss"] = bool(d["l1_loss"])
            d["reg_loss"] = "l1_loss"
        d.pop("l1_loss", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = {k: v for k, v in d.items() if k not in known}
        cfg = cls(**{k: v for k, v in d.items() if k in known})
        cfg._unknown = unknown  # type: ignore[attr-defined]
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def load_train_opts(path: str) -> SEGANConfig:
    """Load a reference-format train.opts JSON."""
    with open(path, "r") as f:
        return SEGANConfig.from_dict(json.load(f))


def dump_train_opts(cfg: SEGANConfig, save_path: Optional[str] = None) -> str:
    """Dump config as train.opts JSON into ``save_path`` (default ``cfg.save_path``)."""
    save_path = save_path or cfg.save_path
    os.makedirs(save_path, exist_ok=True)
    out = os.path.join(save_path, "train.opts")
    with open(out, "w") as f:
        f.write(cfg.to_json())
    return out
