"""SEGAN engine: the counterpart of ``segan_pytorch_tpu/models/segan.py``: inference, the
losses, the optimizers and the three-phase train step (the train loop is not ported yet).

``generate`` enhances one utterance: its 16384-sample chunk grid goes through G as one
batch, every chunk of the utterance sharing one z row, then the chunks are joined
(hard cut, or hann overlap-add with ``overlap`` > 0) and de-emphasized on the host.
``generate_batch`` puts the chunk grids of many utterances into one batch. G in eval
mode treats rows independently, so neither pads the chunk count to a power of two as
the JAX package does to bound XLA's compiled shapes.

z comes from a CPU ``torch.Generator`` seeded by ``cfg.seed`` (or the caller's seed):
the same stream, and so the same outputs, on every device. Its numbers differ from
``jax.random``; the parity tests pass z in.

``train_step`` is ``make_segan_train_step``: one G forward; D's real and fake passes on
the detached Genh, their losses summed, one D step; G's objective (LSGAN + l1_weight x
the reg loss) through the updated D, differentiated with respect to Genh alone and
pulled back through G; one G step. D's BatchNorm statistics move real -> fake -> fake'
as torch's stateful BN moves them. Master parameters are fp32; under bf16 each pass runs
on bf16 copies (``torch.func.functional_call``), so the gradients land on the fp32
parameters. The step's z draws come from a generator on the engine's device and its
phase draws from a CPU one, both seeded from the engine's seed; tests pass both in.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import conv as conv_ops
from ..ops.conv import at_least_fp32
from ..ops.signal import de_emphasize_np
from ..parallel.inference import chunk_grid, overlap_add
from ..utils.checkpoint import load_generator
from .discriminator import Discriminator, build_discriminator, d_input
from .generator import Generator, build_generator


def compute_dtype_of(cfg) -> torch.dtype:
    name = getattr(cfg, "compute_dtype", "float32")
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "fp32", "f32"):
        return torch.float32
    raise ValueError(f"Unsupported compute_dtype {name!r}: use 'float32' or 'bfloat16'")


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the batch rows with mask 1 (the plain mean on a full batch), in fp32
    (or wider) whatever x's dtype."""
    per = at_least_fp32(x).reshape(x.shape[0], -1).mean(dim=1)
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def masked_mse(logits: torch.Tensor, label: float, mask: torch.Tensor) -> torch.Tensor:
    return masked_mean((at_least_fp32(logits).reshape(logits.shape[0], -1) - label) ** 2,
                       mask)


def masked_bce_logits(logits: torch.Tensor, label: float,
                      mask: torch.Tensor) -> torch.Tensor:
    """binary_cross_entropy_with_logits: max(x, 0) - x y + log(1 + exp(-|x|))."""
    x = at_least_fp32(logits).reshape(logits.shape[0], -1)
    per = torch.clamp_min(x, 0) - x * label + torch.log1p(torch.exp(-x.abs()))
    return masked_mean(per, mask)


def reg_loss_fn(kind: str) -> Callable:
    """(a, b, mask) -> the masked mean of |a - b| ('l1_loss') or (a - b)^2 ('mse_loss')."""
    if kind == "l1_loss":
        return lambda a, b, mask: masked_mean((at_least_fp32(a) - at_least_fp32(b)).abs(),
                                              mask)
    if kind == "mse_loss":
        return lambda a, b, mask: masked_mean((at_least_fp32(a) - at_least_fp32(b)) ** 2,
                                              mask)
    raise ValueError(f"Unrecognized reg loss {kind}")


def build_optimizer(opt: str, lr: float, params, betas=(0.0, 0.9)) -> torch.optim.Optimizer:
    """Upstream's optimizers: RMSprop(lr, alpha 0.99, eps 1e-8), which is optax
    ``rmsprop(eps_in_sqrt=False)``, or Adam(lr, betas, eps 1e-8). The betas go in as
    floats (torch 2.13 refuses a mix of int and float). Never ``fused=True``: the
    tensor-core kernel's weight cache is keyed by each weight's version counter, which
    the foreach and for-loop steps bump and a fused Adam step on an H100 left as it was."""
    if opt == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8)
    if opt == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(float(betas[0]), float(betas[1])),
                                eps=1e-8)
    raise ValueError(f"Unrecognized optimizer {opt}")


def default_device() -> torch.device:
    """CUDA; without a card it raises rather than run on the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: pass device='cpu' (the CLI: --device cpu) "
                           "to run on the CPU")
    return torch.device("cuda")


class SEGAN:
    """SEGAN / SEGAN+: G inference, and the train step (see the module docstring)."""

    def __init__(self, cfg, generator: Optional[Generator] = None, device=None,
                 seed: Optional[int] = None, discriminator: Optional[Discriminator] = None):
        self.cfg = cfg
        self.preemph = cfg.preemph
        self.device = torch.device(device) if device is not None else default_device()
        self.compute_dtype = compute_dtype_of(cfg)
        seed = cfg.seed if seed is None else seed
        self.seed = seed
        # built by init_train(): D (unless given here) and the two optimizers
        self.D = discriminator.to(self.device) if discriminator is not None else None
        self.g_opt: Optional[torch.optim.Optimizer] = None
        self.d_opt: Optional[torch.optim.Optimizer] = None
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

    # -- training -------------------------------------------------------------
    def init_train(self):
        """Build, once, what training adds: D (from seed + 2, unless one was given), the
        optimizers of G and D (``cfg.opt``, ``cfg.g_lr``, ``cfg.d_lr``), the reg loss,
        and the streams of z (on the device, seed + 3) and phase draws (CPU, seed + 4)."""
        if self.g_opt is not None:
            return
        cfg = self.cfg
        if self.D is None:
            self.D = build_discriminator(
                cfg, torch.Generator().manual_seed(self.seed + 2)).to(self.device)
        self.g_opt = build_optimizer(cfg.opt, cfg.g_lr, self.G.parameters())
        self.d_opt = build_optimizer(cfg.opt, cfg.d_lr, self.D.parameters())
        self._reg_fn = reg_loss_fn(cfg.reg_loss)
        self._z_train = torch.Generator(device=self.device).manual_seed(self.seed + 3)
        self._phase_train = torch.Generator().manual_seed(self.seed + 4)

    def _run(self, module: torch.nn.Module, *args, **kwargs):
        """module(*args, **kwargs) in the compute dtype: in bf16 on bf16 copies of the
        fp32 parameters, so that autograd takes the gradients back to the fp32 ones."""
        if self.compute_dtype == torch.float32:
            return module(*args, **kwargs)
        params = {n: p.to(self.compute_dtype) for n, p in module.named_parameters()}
        return torch.func.functional_call(module, params, args, kwargs)

    def _g_forward(self, noisy_c: torch.Tensor, z_c: Optional[torch.Tensor]):
        """Phase 1: Genh = G(noisy, z), keeping G's graph for phase 3."""
        return self._run(self.G, noisy_c, z_c)

    def _d_update(self, clean_c, noisy_c, fake, mask, phase):
        """Phase 2: D's real and fake passes, the summed LSGAN loss, one D step."""
        d_real, _ = self._run(self.D, d_input(clean_c, noisy_c), mask=mask, phase=phase[0])
        d_fake, _ = self._run(self.D, d_input(fake, noisy_c), mask=mask, phase=phase[1])
        d_real_loss = masked_mse(d_real, 1.0, mask)
        d_fake_loss = masked_mse(d_fake, 0.0, mask)
        (d_real_loss + d_fake_loss).backward()
        self.d_opt.step()
        return d_real_loss.detach(), d_fake_loss.detach()

    def _g_update(self, Genh, clean, noisy_c, mask, phase, l1_weight: float):
        """Phase 3: G's objective through the updated D, differentiated with respect to
        Genh only (D's gradients stay those of phase 2), then through G; one G step."""
        genh = Genh.detach().requires_grad_()
        d_fake_, _ = self._run(self.D, d_input(genh, noisy_c), mask=mask, phase=phase)
        g_adv = masked_mse(d_fake_, 1.0, mask)
        g_l1 = l1_weight * self._reg_fn(genh, clean, mask)
        (d_genh,) = torch.autograd.grad(g_adv + g_l1, genh)
        Genh.backward(d_genh)
        self.g_opt.step()
        self._G_compute = None  # the bf16 inference copy of G is stale now
        return g_adv.detach(), g_l1.detach()

    def train_step(self, clean, noisy, mask=None, l1_weight: float = 100.0, z=None,
                   phase=None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                        Optional[torch.Tensor]]:
        """One three-phase step on clean and noisy (B, T, 1) with a (B,) mask (None: all
        rows; rows with mask 0 count in no statistic and no loss).

        z (B, T', z_dim) and phase ((3, n_layers, 2) of (shift, right), one row per D
        pass: real, fake, fake') come from the engine's streams when None. Returns
        (metrics, Genh, z): metrics 'd_real', 'd_fake', 'g_adv', 'g_l1' as 0-d fp32
        tensors on the device (reading one waits for the step), Genh (B, T, 1) fp32 and
        the z used. Afterwards every parameter's ``.grad`` holds this step's gradient."""
        self.init_train()
        dev, cdt = self.device, self.compute_dtype
        clean = torch.as_tensor(clean).to(dev, torch.float32)
        noisy = torch.as_tensor(noisy).to(dev, torch.float32)
        mask = (torch.ones(clean.shape[0], device=dev) if mask is None
                else torch.as_tensor(mask).to(dev, torch.float32))
        if z is None and not self.G.no_z:
            z = self.G.sample_z(tuple(noisy.shape), self._z_train)
        z = torch.as_tensor(z).to(dev, torch.float32) if z is not None else None
        if phase is None:
            phase = self.D.sample_phase(self._phase_train, passes=3)
        if phase is None:  # a D without phase shift
            phase = [None] * 3
        self.g_opt.zero_grad(set_to_none=True)
        self.d_opt.zero_grad(set_to_none=True)
        self.G.train()
        self.D.train()
        try:
            # fp32: TF32 off for the backward convs too, which run after a conv's own
            # context has closed
            with conv_ops.full_precision(cdt):
                noisy_c = noisy.to(cdt)
                Genh = self._g_forward(noisy_c, z.to(cdt) if z is not None else None)
                d_real, d_fake = self._d_update(clean.to(cdt), noisy_c, Genh.detach(),
                                                mask, phase[:2])
                g_adv, g_l1 = self._g_update(Genh, clean, noisy_c, mask, phase[2],
                                             l1_weight)
        finally:
            self.G.eval()
            self.D.eval()
        metrics = {"d_real": d_real, "d_fake": d_fake, "g_adv": g_adv, "g_l1": g_l1}
        return metrics, Genh.detach().float(), z
