"""Inference-engine construction for the enhancement front-ends: the counterpart of
``segan_pytorch_tpu/utils/engine.py``."""
from __future__ import annotations

from typing import Optional


def build_enhancement_engine(cfg_file: str, g_ckpt: str, seed: int = 111,
                             device: Optional[str] = None):
    """Returns (cfg, engine): the train.opts config and a SEGAN engine on `device`
    (default: CUDA, which raises without a card) with G loaded strictly and the
    per-utterance z stream seeded from `seed`."""
    from ..models.segan import SEGAN
    from .config import load_train_opts

    cfg = load_train_opts(cfg_file)
    if getattr(cfg, "aewsegan", False) or cfg.wsegan:
        raise NotImplementedError(
            "WSEGAN/AEWSEGAN engines are not ported yet (ROADMAP.md, queue A item 4)")
    segan = SEGAN(cfg, device=device, seed=seed)
    segan.g_load_pretrained(g_ckpt)
    return cfg, segan
