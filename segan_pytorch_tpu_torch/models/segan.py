"""SEGAN inference engine: the inference half of ``segan_pytorch_tpu/models/segan.py``.

``generate`` enhances one utterance: its 16384-sample chunk grid goes through G as one
batch, every chunk of the utterance sharing one z row, then the chunks are joined
(hard cut, or hann overlap-add with ``overlap`` > 0) and de-emphasized on the host.
``generate_batch`` puts the chunk grids of many utterances into one batch. G in eval
mode treats rows independently, so neither pads the chunk count to a power of two as
the JAX package does to bound XLA's compiled shapes.

z comes from a CPU ``torch.Generator`` seeded by ``cfg.seed`` (or the caller's seed):
the same stream, and so the same outputs, on every device. Its numbers differ from
``jax.random``; the parity tests pass z in.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.signal import de_emphasize_np
from ..parallel.inference import chunk_grid, overlap_add
from ..utils.checkpoint import load_generator
from .generator import Generator, build_generator


def compute_dtype_of(cfg) -> torch.dtype:
    name = getattr(cfg, "compute_dtype", "float32")
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "fp32", "f32"):
        return torch.float32
    raise ValueError(f"Unsupported compute_dtype {name!r}: use 'float32' or 'bfloat16'")


def default_device() -> torch.device:
    """CUDA; without a card it raises rather than run on the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: pass device='cpu' (the CLI: --device cpu) "
                           "to run on the CPU")
    return torch.device("cuda")


class SEGAN:
    """Generator inference for SEGAN / SEGAN+ (training is not ported yet)."""

    def __init__(self, cfg, generator: Optional[Generator] = None, device=None,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.preemph = cfg.preemph
        self.device = torch.device(device) if device is not None else default_device()
        self.compute_dtype = compute_dtype_of(cfg)
        seed = cfg.seed if seed is None else seed
        if generator is None:
            generator = build_generator(cfg, torch.Generator().manual_seed(seed))
        self.G = generator.to(self.device).eval()
        self._G_compute: Optional[Generator] = None
        # per-utterance z stream of generate()/generate_batch(), and the stream of
        # infer_G() calls without z (a separate seed, as the JAX engine folds in 1)
        self.z_rng = torch.Generator().manual_seed(seed)
        self._infer_rng = torch.Generator().manual_seed(seed + 1)

    def g_load_pretrained(self, ckpt_path: str):
        """Load G strictly from a reference-format torch .ckpt or a JAX npz checkpoint."""
        load_generator(self.G, ckpt_path)
        self._G_compute = None

    def _g(self) -> Generator:
        """G in the compute dtype (a cast copy for bf16; params stay fp32 in self.G)."""
        if self.compute_dtype == torch.float32:
            return self.G
        if self._G_compute is None:
            self._G_compute = copy.deepcopy(self.G).to(self.compute_dtype)
        return self._G_compute

    def infer_G(self, noisy, z=None, ret_hid: bool = False):
        """G forward on (B, T, 1) in the compute dtype, output fp32 on the device;
        z (B, T', z_dim), or None for a fresh draw."""
        if z is None and not self.G.no_z:
            z = self.G.sample_z(tuple(noisy.shape), self._infer_rng)
        cdt = self.compute_dtype
        x = torch.as_tensor(noisy).to(self.device, cdt)
        z = torch.as_tensor(z).to(self.device, cdt) if z is not None else None
        with torch.inference_mode():
            out, hall = self._g()(x, z, ret_hid=True)
        return (out.float(), hall) if ret_hid else out.float()

    def _forward(self, x: np.ndarray, z: Optional[torch.Tensor]):
        """Chunks (n, N, 1) -> (enhanced chunks, last encoder activation), on the host."""
        out, hall = self.infer_G(x, z, ret_hid=True)
        g_c = hall[f"enc_{len(self.G.enc_blocks) - 1}"]
        return out.cpu().numpy(), g_c.float().cpu().numpy()

    def _z_row(self, z) -> Optional[torch.Tensor]:
        """One utterance's z row (1, T', z_dim): the given one, or the next draw."""
        if self.G.no_z:
            return None
        if z is None:
            return self.G.sample_z((1, self.cfg.slice_size, 1), self.z_rng)
        z = torch.tensor(np.asarray(z, np.float32))
        return z.reshape((1,) + tuple(z.shape[-2:]))

    def _grid(self, wav: np.ndarray, overlap: float) -> Tuple[np.ndarray, int, int]:
        """(chunks (n, N, 1), hop, n) of one utterance, the last chunk zero-padded."""
        N = self.cfg.slice_size
        if overlap > 0:
            return chunk_grid(wav, N, overlap)
        n_chunks = -(-wav.shape[0] // N)
        x = np.zeros((n_chunks * N,), np.float32)
        x[: wav.shape[0]] = wav
        return x.reshape(n_chunks, N, 1), N, n_chunks

    def _join(self, chunks: np.ndarray, hop: int, T: int, overlap: float) -> np.ndarray:
        if overlap > 0:
            wav = overlap_add(chunks, hop, T)
        else:
            wav = chunks.reshape(-1)[:T]
        return de_emphasize_np(wav, self.preemph)

    def generate(self, inwav: np.ndarray, z: Optional[np.ndarray] = None,
                 overlap: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Enhance one normalized, pre-emphasized waveform.

        Returns (enhanced wav (T,), g_c): g_c is the last encoder layer's activation of
        the utterance's chunks, (n_chunks, T', C). `overlap` in [0, 0.5)."""
        if not 0.0 <= overlap < 0.5:
            raise ValueError(f"overlap must be in [0, 0.5), got {overlap}")
        wav = np.asarray(inwav, np.float32).reshape(-1)
        x, hop, n_chunks = self._grid(wav, overlap)
        zrow = self._z_row(z)
        zb = zrow.expand(n_chunks, -1, -1) if zrow is not None else None
        out, g_c = self._forward(x, zb)
        return self._join(out, hop, wav.shape[0], overlap), g_c

    def generate_batch(self, inwavs: Sequence[np.ndarray], overlap: float = 0.0,
                       z: Optional[Sequence[np.ndarray]] = None
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Enhance many waveforms in one G pass; equals one generate() per waveform in
        order (the i-th utterance takes the i-th z draw, or z[i] when given)."""
        if not 0.0 <= overlap < 0.5:
            raise ValueError(f"overlap must be in [0, 0.5), got {overlap}")
        if inwavs is None or len(inwavs) == 0:
            return []
        if z is not None and len(z) != len(inwavs):
            raise ValueError(f"{len(inwavs)} waveforms but {len(z)} z rows")
        grids, metas, z_rows = [], [], []
        for i, inwav in enumerate(inwavs):
            wav = np.asarray(inwav, np.float32).reshape(-1)
            x, hop, n_chunks = self._grid(wav, overlap)
            grids.append(x)
            metas.append((wav.shape[0], hop, n_chunks))
            zrow = self._z_row(None if z is None else z[i])
            if zrow is not None:
                z_rows.append(zrow.expand(n_chunks, -1, -1))
        zb = torch.cat(z_rows, dim=0) if z_rows else None
        out, g_c = self._forward(np.concatenate(grids, axis=0), zb)
        results, pos = [], 0
        for T, hop, n_chunks in metas:
            results.append((self._join(out[pos: pos + n_chunks], hop, T, overlap),
                            g_c[pos: pos + n_chunks]))
            pos += n_chunks
        return results
