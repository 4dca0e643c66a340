"""Inference-engine construction for the enhancement front-ends: the counterpart of
``segan_pytorch_tpu/utils/engine.py``."""
from __future__ import annotations

from typing import Optional


def build_enhancement_engine(cfg_file: str, g_ckpt: str, seed: int = 111,
                             device: Optional[str] = None):
    """Returns (cfg, engine): the train.opts config and its engine (AEWSEGAN, WSEGAN or
    SEGAN) on `device` (default: CUDA, which raises without a card) with G loaded
    strictly and the per-utterance z stream seeded from `seed`.

    ``aewsegan`` is checked first, as the JAX engine does: train.opts of an AEWSEGAN run
    has ``wsegan`` False, and through SEGAN it would be enhanced on the chunk grid
    instead of the one padded pass that both WSEGAN engines make."""
    from ..models.segan import SEGAN
    from ..models.wsegan import AEWSEGAN, WSEGAN
    from .config import load_train_opts

    cfg = load_train_opts(cfg_file)
    if getattr(cfg, "aewsegan", False):
        cls = AEWSEGAN
    elif cfg.wsegan:
        cls = WSEGAN
    else:
        cls = SEGAN
    segan = cls(cfg, device=device, seed=seed)
    segan.g_load_pretrained(g_ckpt)
    return cfg, segan
