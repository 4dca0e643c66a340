"""SEGAN engine: the counterpart of ``segan_pytorch_tpu/models/segan.py``: inference, the
losses, the optimizers, the three-phase train step and the training run around it
(``train``, ``evaluate``, ``save``, ``resume``).

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

``train`` is the JAX loop for one process: batches go to the card one ahead
(``data/loader.py`` ``device_prefetch``), the L1 weight decays per batch after
``l1_dec_epoch``, losses are read on the host only at log points, the validation set is
scored (PESQ, SSNR, CSIG, CBAK, COVL) on a pool of spawned host processes after each
epoch, the best COVL + PESQ + SSNR is kept with patience, and G and D with their
optimizers go to rotating end-of-epoch (EOE) checkpoints written on a background
thread. ``resume`` continues from them; SIGTERM checkpoints and stops at the next step
boundary. A checkpoint is named after the loop's iteration, as in the JAX package, and
records the steps taken, one fewer: the JAX engine resumes at the iteration, one step
ahead of the steps it took, while the port resumes at the steps taken, so a resumed run
continues the L1 schedule and the iteration count exactly.
"""
from __future__ import annotations

import contextlib
import copy
import multiprocessing
import os
import signal
import threading
import timeit
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import conv as conv_ops
from ..ops.conv import at_least_fp32
from ..ops.signal import de_emphasize_np
from ..parallel import sharding
from ..parallel.inference import chunk_grid, overlap_add
from ..parallel.mesh import (Grid, distributed_barrier, host_group, launcher_count,
                             make_grid, process_count, process_index)
from ..utils.checkpoint import (Saver, discriminator_bridge, generator_state_from_jax,
                                load_discriminator, load_generator, load_payload)
from .discriminator import Discriminator, build_discriminator, d_input
from .generator import Generator, build_generator
from .modules import BatchNorm1d
from .multistep import StepGraph, set_capturable


def compute_dtype_of(cfg) -> torch.dtype:
    name = getattr(cfg, "compute_dtype", "float32")
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "fp32", "f32"):
        return torch.float32
    raise ValueError(f"Unsupported compute_dtype {name!r}: use 'float32' or 'bfloat16'")


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the batch rows with mask 1 (the plain mean on a full batch), in fp32
    (or wider) whatever x's dtype. `count`: the rows that the mean is over, when they are
    not only these (a multi-GPU step's global count: each rank then holds its rows' part
    of the global mean, and the parts sum to it)."""
    per = at_least_fp32(x).reshape(x.shape[0], -1).mean(dim=1)
    if count is None:
        count = torch.clamp_min(mask.sum(), 1.0)
    return (per * mask).sum() / count


def masked_mse(logits: torch.Tensor, label: float, mask: torch.Tensor,
               count: Optional[torch.Tensor] = None) -> torch.Tensor:
    return masked_mean((at_least_fp32(logits).reshape(logits.shape[0], -1) - label) ** 2,
                       mask, count)


def masked_bce_logits(logits: torch.Tensor, label: float, mask: torch.Tensor,
                      count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """binary_cross_entropy_with_logits: max(x, 0) - x y + log(1 + exp(-|x|))."""
    x = at_least_fp32(logits).reshape(logits.shape[0], -1)
    per = torch.clamp_min(x, 0) - x * label + torch.log1p(torch.exp(-x.abs()))
    return masked_mean(per, mask, count)


def reg_loss_fn(kind: str) -> Callable:
    """(a, b, mask, count=None) -> the masked mean of |a - b| ('l1_loss') or (a - b)^2
    ('mse_loss')."""
    if kind == "l1_loss":
        return lambda a, b, mask, count=None: masked_mean(
            (at_least_fp32(a) - at_least_fp32(b)).abs(), mask, count)
    if kind == "mse_loss":
        return lambda a, b, mask, count=None: masked_mean(
            (at_least_fp32(a) - at_least_fp32(b)) ** 2, mask, count)
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


# the compute-dtype copy of G is built once, whichever thread that runs G asks first (a
# server's batcher threads, or a handler or WebSocket thread that runs a stream's windows)
_G_COPY_LOCK = threading.Lock()


def default_device() -> torch.device:
    """CUDA; without a card it raises rather than run on the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: pass device='cpu' (the CLI: --device cpu) "
                           "to run on the CPU")
    return torch.device("cuda")


class SEGAN:
    """SEGAN / SEGAN+: G inference, the train step and the training run (see the module
    docstring)."""

    name = "SEGAN"

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
        self.step = 0  # train steps taken (after resume(): the checkpoint's)
        # the grid of a multi-GPU run (init_train): its data and model axes
        self.grid: Optional[Grid] = None
        self._data = self._model = None
        self._n = None  # a grouped step's global count of valid rows
        self._multi: Optional[StepGraph] = None  # the step's CUDA graph, when prepared
        self._step_flops: Optional[int] = None
        self.pool = None  # the evaluation worker pool, kept across epochs
        self.writer = None
        self._preempted = False

    def _chief(self) -> bool:
        """Whether this process writes the run's files: process 0 of a group."""
        return process_index() == 0

    def _whole_head(self):
        """D's head whole inside the block on every rank of the model axis (a
        collective), split again after (``parallel/sharding.py`` ``whole_head``). A
        split head comes back in new tensors, so the step's graph, which recorded the
        old ones, is released first."""
        if self._model is None or self.D is None:
            return contextlib.nullcontext()
        if self._model.size > 1:
            self.release_multi_step()
        return sharding.whole_head(self.D, self.d_opt, self._model)

    def g_load_pretrained(self, ckpt_path: str):
        """Load G strictly from a reference-format torch .ckpt or a JAX npz checkpoint."""
        load_generator(self.G, ckpt_path)
        self._G_compute = None

    def d_load_pretrained(self, ckpt_path: str):
        """Load D (built first if need be) strictly, as G is loaded."""
        self.init_train()
        with self._whole_head():
            load_discriminator(self.D, ckpt_path)

    def get_n_params(self) -> int:
        """Parameters of G and D."""
        self.init_train()
        with self._whole_head():
            return sum(p.numel() for m in (self.G, self.D) for p in m.parameters())

    def _g(self) -> Generator:
        """G in the compute dtype (a cast copy for bf16; params stay fp32 in self.G). The
        copy casts the parameters alone: spectral norm's u and v buffers stay fp32, as
        the JAX 'spectral' collection does under bf16."""
        if self.compute_dtype == torch.float32:
            return self.G
        if self._G_compute is None:
            # made with inference mode off whoever calls (infer_G does under it): the
            # kernel caches its padded and permuted weights by weight and version, and an
            # inference tensor has no version, so each call would make them anew
            with _G_COPY_LOCK, torch.inference_mode(False):
                if self._G_compute is None:
                    g = copy.deepcopy(self.G)
                    for p in g.parameters():
                        p.data = p.data.to(self.compute_dtype)
                    self._G_compute = g
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

    def _z_row(self, z, length: Optional[int] = None) -> Optional[torch.Tensor]:
        """One utterance's z row (1, T', z_dim): the given one, or the next draw for an
        input of `length` samples (default: a slice)."""
        if self.G.no_z:
            return None
        if z is None:
            return self.G.sample_z((1, length or self.cfg.slice_size, 1), self.z_rng)
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
        """Build, once, what training adds (``_build_train``), then place it on the grid
        of a multi-GPU run (``_setup_parallel``)."""
        if self.g_opt is not None:
            return
        self._build_train()
        self._setup_parallel()

    def _build_train(self):
        """D (from seed + 2, unless one was given), the optimizers of G and D
        (``cfg.opt``, ``cfg.g_lr``, ``cfg.d_lr``), the reg loss, and the streams of z
        (on the device, seed + 3) and phase draws (CPU, seed + 4)."""
        cfg = self.cfg
        if self.D is None:
            self.D = build_discriminator(
                cfg, torch.Generator().manual_seed(self.seed + 2)).to(self.device)
        self.g_opt = build_optimizer(cfg.opt, cfg.g_lr, self.G.parameters())
        self.d_opt = build_optimizer(cfg.opt, cfg.d_lr, self.D.parameters())
        self._reg_fn = reg_loss_fn(cfg.reg_loss)
        self._seed_step_streams(self.seed)

    def _setup_parallel(self):
        """The grid of a multi-GPU run (the JAX ``_setup_parallel``, ``:618-629``), when
        ``cfg.dp`` or ``cfg.mp`` is above 1 or a process group was joined: every process
        of the group drives its card, dp x mp of them (dp, when ``cfg.dp`` is 1, the
        process count over mp). The batch must divide by dp. The BatchNorms of G and D
        take the data axis (global statistics), and D's head is split over the model
        axis with its optimizer moments (``parallel/sharding.py``)."""
        cfg = self.cfg
        dp = cfg.dp if cfg.dp and cfg.dp > 1 else None
        mp = getattr(cfg, "mp", 1) or 1
        if dp is None and mp == 1 and not dist.is_initialized():
            return
        grid = make_grid(dp, mp)
        if cfg.batch_size % grid.dp != 0:
            raise ValueError(f"batch_size ({cfg.batch_size}) must be divisible by the "
                             f"data-parallel factor --dp ({grid.dp})")
        self.grid = grid
        self._data = sharding.Axis(grid.dp_group, grid.dp, grid.dp_index)
        self._model = sharding.Axis(grid.mp_group, grid.mp, grid.mp_index)
        for model in (self.G, self.D):
            for m in (model.modules() if model is not None else ()):
                if isinstance(m, BatchNorm1d):
                    m.axis = self._data
        if self.D is not None:
            sharding.shard_head(self.D, self.d_opt, self._model)

    def _local(self, t: Optional[torch.Tensor], B: int) -> Optional[torch.Tensor]:
        """This rank's rows of a draw for the global batch (all of them without a grid);
        B is the rows of the local batch."""
        if t is None or self.grid is None:
            return t
        return t[self.grid.rows(B)]

    def _count(self, mask: torch.Tensor) -> Optional[torch.Tensor]:
        """The valid rows of the global batch under a grid (the losses' count), else
        None."""
        if self.grid is None:
            return None
        return torch.clamp_min(sharding.sum_values([mask.sum()], self._data)[0], 1.0)

    def _reduce_grads(self, module: torch.nn.Module):
        """Sum `module`'s gradients over the data axis, before its optimizer steps."""
        if self.grid is not None:
            sharding.reduce_gradients(module.parameters(), self._data)

    def _sum_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A step's losses of the global batch: each rank's parts summed over the data
        axis, in one all-reduce."""
        if self.grid is None:
            return metrics
        return dict(zip(metrics, sharding.sum_values(metrics.values(), self._data)))

    def _seed_step_streams(self, base: int):
        """The step's z stream (on the device, base + 3) and phase stream (CPU, base + 4)."""
        self._z_train = torch.Generator(device=self.device).manual_seed(base + 3)
        self._phase_train = torch.Generator().manual_seed(base + 4)

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
        d_real_loss = masked_mse(d_real, 1.0, mask, self._n)
        d_fake_loss = masked_mse(d_fake, 0.0, mask, self._n)
        (d_real_loss + d_fake_loss).backward()
        self._reduce_grads(self.D)
        self.d_opt.step()
        return d_real_loss.detach(), d_fake_loss.detach()

    def _g_update(self, Genh, clean, noisy_c, mask, phase, l1_weight: torch.Tensor):
        """Phase 3: G's objective through the updated D, differentiated with respect to
        Genh only (D's gradients stay those of phase 2), then through G; one G step."""
        genh = Genh.detach().requires_grad_()
        d_fake_, _ = self._run(self.D, d_input(genh, noisy_c), mask=mask, phase=phase)
        g_adv = masked_mse(d_fake_, 1.0, mask, self._n)
        g_l1 = l1_weight * self._reg_fn(genh, clean, mask, self._n)
        (d_genh,) = torch.autograd.grad(g_adv + g_l1, genh)
        Genh.backward(d_genh)
        self._reduce_grads(self.G)
        self.g_opt.step()
        self._G_compute = None  # the bf16 inference copy of G is stale now
        return g_adv.detach(), g_l1.detach()

    # the batch fields of a step, in the order train_step and train_step_multi take them
    batch_keys = ("clean", "noisy", "mask")

    def n_d_passes(self) -> int:
        """D passes of a step: real, fake and G's."""
        return 3

    def _inputs(self, clean, noisy, mask=None) -> Dict[str, torch.Tensor]:
        """The batch on the device in fp32; mask None means every row."""
        dev = self.device
        clean = torch.as_tensor(clean).to(dev, torch.float32)
        noisy = torch.as_tensor(noisy).to(dev, torch.float32)
        mask = (torch.ones(clean.shape[0], device=dev) if mask is None
                else torch.as_tensor(mask).to(dev, torch.float32))
        return {"clean": clean, "noisy": noisy, "mask": mask}

    def _draw(self, B: int, T: int, z=None, phase=None) -> Dict[str, Optional[torch.Tensor]]:
        """A step's draws, each the given one or the next from the engine's streams: z
        (B, T', z_dim) on the device, and the phase shifts of D's passes (n_d_passes(),
        n_layers, 2) on the host (None for a D without phase shift). Under a grid every
        rank draws for the global batch (B x dp rows; a given z is the global one) from
        the same streams and keeps its rows."""
        if z is None and not self.G.no_z:
            z = self.G.sample_z((B * self._dp(), T, 1), self._z_train)
        if phase is None:
            phase = self.D.sample_phase(self._phase_train, passes=self.n_d_passes())
        z = self._local(torch.as_tensor(z), B) if z is not None else None
        return {"z": (z.to(self.device, torch.float32) if z is not None else None),
                "phase": torch.as_tensor(phase) if phase is not None else None}

    def _dp(self) -> int:
        """The data-parallel degree: the global batch over this rank's."""
        return self.grid.dp if self.grid is not None else 1

    def _l1(self, l1_weight) -> torch.Tensor:
        """The L1 weight as a 0-d fp32 tensor on the device: the fill takes the value as
        an argument, so no copy waits for the card (a fp32 product with it equals one
        with the float)."""
        return torch.full((), float(l1_weight), device=self.device)

    def _body(self, x: Dict[str, torch.Tensor], l1_weight: torch.Tensor,
              draws: Dict[str, Optional[torch.Tensor]]):
        """The three-phase step on device tensors alone, with no host read: what a CUDA
        graph of the step records. Returns (metrics, Genh)."""
        cdt = self.compute_dtype
        clean, noisy, mask, z = x["clean"], x["noisy"], x["mask"], draws["z"]
        phase = draws["phase"] if draws["phase"] is not None else [None] * 3
        self._n = self._count(mask)
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
        return self._sum_metrics(metrics), Genh.detach().float()

    def train_step(self, clean, noisy, mask=None, l1_weight: float = 100.0, z=None,
                   phase=None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                        Optional[torch.Tensor]]:
        """One three-phase step on clean and noisy (B, T, 1) with a (B,) mask (None: all
        rows; rows with mask 0 count in no statistic and no loss).

        z (B, T', z_dim) and phase ((3, n_layers, 2) of (shift, right), one row per D
        pass: real, fake, fake') come from the engine's streams when None. Returns
        (metrics, Genh, z): metrics 'd_real', 'd_fake', 'g_adv', 'g_l1' as 0-d fp32
        tensors on the device (reading one waits for the step), Genh (B, T, 1) fp32 and
        the z used. Afterwards every parameter's ``.grad`` holds this step's gradient.

        Under a grid (``_setup_parallel``) clean, noisy and mask are this rank's rows of
        the global batch, z is given for the global batch, and the step is the one step
        of the global batch: global BatchNorm statistics and loss means, gradients summed
        over the data axis; the metrics are the global batch's, Genh and z this rank's
        rows."""
        self.init_train()
        x = self._inputs(clean, noisy, mask)
        draws = self._draw(*x["clean"].shape[:2], z=z, phase=phase)
        metrics, Genh = self._body(x, self._l1(l1_weight), draws)
        self.step += 1
        return metrics, Genh, draws["z"]

    # -- several steps per call -----------------------------------------------
    def _parameters(self):
        return [p for m in (self.G, self.D) if m is not None for p in m.parameters()]

    def _buffers(self):
        return [b for m in (self.G, self.D) if m is not None for b in m.buffers()]

    def _optimizers(self):
        return [o for o in (self.g_opt, self.d_opt) if o is not None]

    def prepare_multi_step(self, steps_per_call: int):
        """Get ready for ``train_step_multi`` (the JAX ``prepare_multi_step``): on a CUDA
        device the optimizers keep their step counts on the card, and the step's graph
        (``models/multistep.py`` ``StepGraph``) is captured at the first call's second
        sub-step; on the CPU nothing changes. ``release_multi_step`` undoes it.

        Under a grid on the card the graph holds the step's collectives, which only
        NCCL can record: a grid over another backend (gloo, whose all-reduce waits on
        the host) raises RuntimeError."""
        self.init_train()
        if self.device.type == "cuda" and self.grid is not None:
            backends = {dist.get_backend(g) for g in (self.grid.dp_group, self.grid.mp_group)
                        if g is not None}
            if backends != {"nccl"}:
                raise RuntimeError(
                    f"steps_per_call {steps_per_call} on {self.device} replays the step as "
                    "one CUDA graph with its collectives, and the process group's "
                    f"{'/'.join(sorted(backends))} backend cannot be captured: join the "
                    "group over NCCL, or use steps_per_call 1")
        if self.device.type == "cuda" and self._multi is None:
            for opt in self._optimizers():
                set_capturable(opt, True)
            self._multi = StepGraph(self)
        return self

    def release_multi_step(self):
        """Free the step's graph and its pool, and give the optimizers their host step
        counts back."""
        if self._multi is not None:
            self._multi.release()
            self._multi = None
            for opt in self._optimizers():
                set_capturable(opt, False)

    def train_step_multi(self, *stacked, l1_w_s: Sequence[float], **draws_s):
        """S steps in one call (the JAX ``train_step_multi``): ``stacked`` are the batch
        fields of ``batch_keys`` with a leading (S,) axis (mask may be None), ``l1_w_s``
        one L1 weight per sub-step, and ``draws_s`` optional stacked draws by name (z,
        phase; WSEGAN also perm, squares), each drawn from the engine's streams where not
        given, in the order S ``train_step`` calls draw them.

        On a CUDA device each sub-step is a replay of the step's CUDA graph, with no host
        sync; under a grid the graph holds the step's NCCL collectives, which every rank
        records in the same order. On the CPU the same body runs S times. Returns
        (metrics_s, metrics, Genh, z): each metric of every sub-step as an (S,) tensor,
        the last sub-step's metrics, its Genh (B, T, 1) fp32 and its z. Afterwards
        ``step`` is S further on and every parameter's ``.grad`` holds the last
        sub-step's gradient."""
        if len(stacked) != len(self.batch_keys):
            raise TypeError(f"{type(self).__name__}.train_step_multi takes "
                            f"{', '.join(self.batch_keys)}; got {len(stacked)} arrays")
        self.init_train()
        S = len(l1_w_s)
        if self.device.type == "cuda":
            self.prepare_multi_step(S)
        xs = [self._inputs(*(v[i] if v is not None else None for v in stacked))
              for i in range(S)]
        B, T = xs[0]["clean"].shape[:2]
        draws = [self._draw(B, T, **{k: (v[i] if v is not None else None)
                                     for k, v in draws_s.items()}) for i in range(S)]
        if self.device.type == "cuda":
            metrics_s, Genh = self._multi.run(xs, l1_w_s, draws)
        elif self.device.type == "cpu":
            rows = [self._body(x, self._l1(l1), d) for x, l1, d in zip(xs, l1_w_s, draws)]
            metrics_s = {k: torch.stack([m[k] for m, _ in rows]) for k in rows[0][0]}
            Genh = rows[-1][1]
        else:
            raise ValueError(f"train_step_multi runs on cuda or cpu, not {self.device}")
        self.step += S
        self._G_compute = None
        return metrics_s, {k: v[-1] for k, v in metrics_s.items()}, Genh, draws[-1]["z"]

    @staticmethod
    def _stack_group(batches, extra_keys=()):
        """Loader batches (on the device) as the stacked fields ``train_step_multi``
        takes: clean and noisy (S, B, T, 1), mask (S, B) (all ones where a batch has
        none), then ``extra_keys`` (WSEGAN's additive_mask)."""
        clean = torch.stack([b["clean"][..., None] for b in batches])
        noisy = torch.stack([b["noisy"][..., None] for b in batches])
        mask = torch.stack([b["mask"] if b.get("mask") is not None
                            else torch.ones(b["clean"].shape[0], device=b["clean"].device)
                            for b in batches])
        extras = tuple(torch.stack([torch.as_tensor(b[k]).to(b["clean"].device)
                                    for b in batches]) for k in extra_keys)
        return (clean, noisy, mask) + extras

    def step_flops(self) -> int:
        """The FLOPs of one train step of this engine at its batch (``cfg.batch_size``,
        under a grid this process's part of it):
        every convolution, transposed convolution and matmul, forward and backward, the
        hand-written kernel's included, as ``torch.utils.flop_counter`` counts them on
        the plain route. It runs the step's body on a copy of the engine made of fake CPU
        tensors (``FakeTensorMode``: shapes, no data, no optimizer step), so it is the
        same on every device, depends on no data and leaves the engine untouched: no
        parameter, buffer, optimizer state or stream moves. Computed once and cached.
        The counterpart of the JAX ``step_flops``, which reads XLA's cost analysis and
        also counts the elementwise work."""
        if self._step_flops is None:
            from torch._subclasses.fake_tensor import FakeTensorMode

            from ..utils.profiling import count_flops

            self.init_train()
            mode = FakeTensorMode()
            fake = _fake_engine(self, mode)
            # under a grid, this process's rows: the step's FLOPs on its card
            B, T = int(self.cfg.batch_size) // self._dp(), int(self.cfg.slice_size)
            with mode:
                x = fake._inputs(*(torch.zeros((B, T, 1) if k in ("clean", "noisy")
                                               else (B,)) for k in self.batch_keys))
                draws = fake._draw(B, T)
                self._step_flops = count_flops(
                    lambda: fake._body(x, fake._l1(1.0), draws))
        return self._step_flops

    # -- the training run -----------------------------------------------------
    def _install_preempt_handler(self):
        """SIGTERM -> finish the in-flight step, checkpoint, exit cleanly. Returns a
        restore() callable; a no-op off the main thread, where no signal arrives."""
        self._preempted = False
        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def _on_term(signum, frame):
            self._preempted = True
            print("[!] SIGTERM: checkpoint + clean shutdown at the next step "
                  "boundary", flush=True)

        try:
            prev = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # non-main interpreter contexts
            return lambda: None
        return lambda: signal.signal(signal.SIGTERM, prev)

    def train(self, cfg, dloader, l1_init: float = 100.0, l1_dec_step: float = 1e-5,
              l1_dec_epoch: int = 100, log_freq: int = 50, va_dloader=None):
        """The SEGAN training loop of one process, with the JAX loop's bookkeeping:
        iterations, the L1 schedule, log points, checkpoint names and early stop.

        ``cfg.steps_per_call`` S > 1 runs S steps per call (``train_step_multi``: on the
        card one CUDA graph of the step, replayed S times, freed when the loop ends).
        Groups never span an epoch: the ragged tail runs single steps, so the EOE
        evaluation and checkpoints fall at the same steps; the L1 weight decays per
        sub-step as with single steps. In a group every rank takes its S batches from its
        data shard and replays the step's graph with its collectives; S falls to 1 only
        for processes launched apart (``_steps_per_call``). ``cfg.profile`` waits for
        every step (its times are then the device's), traces batches 2-7 of the first
        epoch with ``torch.profiler`` into ``save_path/profile``, prints the device
        memory and, from batch 3, ends each log line with the step's MFU when the card's
        peak is known (``utils/profiling.py``); it forces S to 1, as in JAX."""
        from ..data.loader import device_prefetch, host_float32
        from ..utils.logging import StepTimer, TrainLogger
        from ..utils.profiling import device_memory_stats, device_trace, mfu

        self.init_train()
        is_chief = self._chief()
        self.writer = TrainLogger(os.path.join(cfg.save_path, "train"), enabled=is_chief)
        # payloads are written on a background thread, after a synchronous copy to the
        # host
        eoe_g_saver = Saver(cfg.save_path, max_ckpts=3, prefix="EOE_G-", async_write=True)
        eoe_d_saver = Saver(cfg.save_path, max_ckpts=3, prefix="EOE_D-", async_write=True)
        best_saver_g = Saver(cfg.save_path, max_ckpts=3, prefix=f"{self.name}-G-",
                             async_write=True)
        best_saver_d = Saver(cfg.save_path, max_ckpts=3, prefix=f"{self.name}-D-",
                             async_write=True)
        num_batches = len(dloader)
        # resume-aware counters: iterations go on from the checkpoint's step and the L1
        # schedule is fast-forwarded to it
        start_step = self.step
        iteration = start_step + 1
        start_epoch = start_step // max(num_batches, 1) + 1
        l1_weight = l1_init
        past = start_step - max(0, (l1_dec_epoch - 1)) * num_batches
        if past > 0:
            l1_weight = max(0.0, l1_init - l1_dec_step * past)
        timer = StepTimer()
        profiling = bool(getattr(cfg, "profile", False))
        trace_ctx = None  # the device trace over batches 2-7 of the first epoch
        step_mfu = None

        def end_trace():
            nonlocal trace_ctx
            trace_ctx.__exit__(None, None, None)
            trace_ctx = None
            print(f"[profile] device trace written to "
                  f"{os.path.join(cfg.save_path, 'profile')}")
            print(f"[profile] memory: {device_memory_stats()}")

        evals = {}
        noisy_evals = {}
        noisy_samples = None
        clean_samples = None
        z_sample = None
        patience = cfg.patience
        best_val_obj = 0
        self._seed_step_streams(self.seed + start_step)
        restore_sig = self._install_preempt_handler()
        S = self._steps_per_call(cfg)
        if S > 1 and profiling:
            print("[!] --profile needs per-step dispatch; steps_per_call -> 1")
            S = 1
        if S > 1:
            # before the first step: every step of the run, single or grouped, keeps one
            # optimizer mode, and a backend that cannot be captured refuses before a batch
            self.prepare_multi_step(S)
        for epoch in range(start_epoch, cfg.epoch + 1):
            timer.start()
            stream = device_prefetch(iter(dloader), self.device)
            bidx = 0
            while bidx < num_batches:
                prev_bidx = bidx
                n_sub = S if num_batches - bidx >= S else 1
                if n_sub > 1:
                    batches = [next(stream) for _ in range(n_sub)]
                    l1_w_s = []
                    for _ in range(n_sub):
                        if epoch >= l1_dec_epoch and l1_weight > 0:
                            l1_weight = max(0.0, l1_weight - l1_dec_step)
                        l1_w_s.append(l1_weight)
                    _, metrics, Genh, z = self.train_step_multi(
                        *self._stack_group(batches), l1_w_s=l1_w_s)
                    batch = batches[-1]  # the last sub-batch: samples and histograms
                else:
                    if epoch >= l1_dec_epoch and l1_weight > 0:
                        l1_weight = max(0.0, l1_weight - l1_dec_step)
                    batch = next(stream)
                    metrics, Genh, z = self.train_step(batch["clean"][..., None],
                                                       batch["noisy"][..., None],
                                                       batch.get("mask"), l1_weight)
                clean = batch["clean"][..., None]  # (B, T, 1), on the device
                noisy = batch["noisy"][..., None]
                bidx += n_sub
                iteration += n_sub - 1  # and one more at the bottom of the loop
                if noisy_samples is None:  # from the host copy: no device sync
                    noisy_samples = host_float32(batch["host"]["noisy"][:20])[..., None]
                    clean_samples = host_float32(batch["host"]["clean"][:20])[..., None]
                    if z is not None:
                        z_sample = z[:20].clone()
                if profiling:
                    float(metrics["d_real"])  # the step's time is the device's
                timer.stop()
                if profiling and epoch == start_epoch:
                    # batches 1-2 build cuDNN's plans and the allocator's pools: trace
                    # 3-7, then report the MFU of one step and the device memory
                    if bidx == 2:
                        trace_ctx = device_trace(os.path.join(cfg.save_path, "profile"))
                        trace_ctx.__enter__()
                    elif bidx == 7 and trace_ctx is not None:
                        end_trace()
                    if bidx >= 3 and step_mfu is None:
                        step_mfu = mfu(self.step_flops(), timer.last)
                timer.start()
                if bidx // log_freq != prev_bidx // log_freq or bidx >= num_batches:
                    # the losses are read on the host here only: a sync point
                    m = {k: float(v) for k, v in metrics.items()}
                    mfu_str = (f", mfu: {100 * step_mfu:.1f}%" if step_mfu is not None
                               else "")
                    print(
                        f"(Iter {iteration}) Batch {bidx}/{num_batches} (Epoch {epoch})"
                        f" d_real:{m['d_real']:.4f}, d_fake:{m['d_fake']:.4f},"
                        f" g_adv:{m['g_adv']:.4f}, g_l1:{m['g_l1']:.4f}"
                        f" l1_w: {l1_weight:.2f}, btime: {timer.last:.4f} s,"
                        f" mbtime: {timer.mean:.4f} s{mfu_str}", flush=True)
                    self.writer.scalar("D_real", m["d_real"], iteration)
                    self.writer.scalar("D_fake", m["d_fake"], iteration)
                    self.writer.scalar("G_adv", m["g_adv"], iteration)
                    self.writer.scalar("G_l1", m["g_l1"], iteration)
                    self.writer.histogram("Gz", Genh, iteration)
                    self.writer.histogram("clean", clean, iteration)
                    self.writer.histogram("noisy", noisy, iteration)
                    self.writer.weight_norms(self.G, "Gtotal", iteration)
                    self.writer.weight_norms(self.D, "Dtotal", iteration)
                    if not cfg.no_train_gen and is_chief:
                        self.gen_train_samples(clean_samples, noisy_samples, z_sample,
                                               iteration=iteration)
                iteration += 1
                if self._preempted:
                    break
            if trace_ctx is not None:  # a first epoch of fewer than 7 batches
                end_trace()

            if self._preempted:
                print(f"[!] preempted at iteration {iteration - 1}: saving "
                      "checkpoint and stopping")
                self.save(eoe_g_saver, eoe_d_saver, iteration)
                break

            if va_dloader is not None:
                # eval_max_samples: batches scored per epoch (1 = upstream's, 0 = all)
                ems = int(getattr(cfg, "eval_max_samples", 1)) or len(va_dloader)
                if len(noisy_evals) == 0:
                    evals_, noisy_evals_ = self.evaluate(cfg, va_dloader, log_freq,
                                                         do_noisy=True, max_samples=ems)
                    for k, v in noisy_evals_.items():
                        noisy_evals.setdefault(k, []).extend(v)
                        self.writer.scalar(f"noisy-{k}", np.mean(v), epoch)
                else:
                    evals_ = self.evaluate(cfg, va_dloader, log_freq, do_noisy=False,
                                           max_samples=ems)
                for k, v in evals_.items():
                    evals.setdefault(k, []).extend(v)
                    self.writer.scalar(f"Genh-{k}", np.mean(v), epoch)
                val_obj = (np.mean(evals_["covl"]) + np.mean(evals_["pesq"])
                           + np.mean(evals_["ssnr"]))
                self.writer.scalar("Genh-val_obj", val_obj, epoch)
                if val_obj > best_val_obj:
                    print(f"Val obj (COVL + SSNR + PESQ) improved "
                          f"{best_val_obj} -> {val_obj}")
                    best_val_obj = val_obj
                    patience = cfg.patience
                    self.save(best_saver_g, best_saver_d, iteration, best_val=True)
                else:
                    patience -= 1
                    print(f"Val loss did not improve. Patience {patience}/{cfg.patience}")
                    if patience <= 0:
                        print("STOPPING SEGAN TRAIN: OUT OF PATIENCE.")
                        break

            if epoch % max(1, getattr(cfg, "eoe_save_every", 1)) == 0 \
                    or epoch == cfg.epoch:
                self.save(eoe_g_saver, eoe_d_saver, iteration)
        restore_sig()
        self.release_multi_step()
        for sv in (eoe_g_saver, eoe_d_saver, best_saver_g, best_saver_d):
            sv.flush()  # every checkpoint byte on disk before train() returns
        self.close_pool()
        self.writer.close()

    def _steps_per_call(self, cfg) -> int:
        """``cfg.steps_per_call``, or 1 in a group of processes launched apart: the JAX
        loops' rule, S = 1 when ``jax.process_count() > 1``. A JAX process drives every
        chip of its host, and its counterpart is the group that ``train --dp N [--mp
        M]`` spawns on one host, not one rank (``parallel/mesh.py`` ``launcher_count``):
        that group keeps S, as does a group of one; ``--num_processes`` P > 1 does not.
        The count is the group's, so every rank takes the same S."""
        S = max(1, int(getattr(cfg, "steps_per_call", 1)))
        if S > 1 and launcher_count() > 1:
            print("[!] steps_per_call > 1 is single-process only; using 1")
            S = 1
        return S

    def save(self, g_saver: Saver, d_saver: Saver, step: int, best_val: bool = False):
        """G and D with their optimizers' state, named after `step` (the loop's
        iteration); each payload records the train steps taken. Every process calls it:
        D's split head is put together first (the JAX ``state_for_ckpt``), so a payload
        is the whole torch state dict, and the chief alone writes."""
        with self._whole_head():
            if not self._chief():
                return
            g_saver.save("Generator", step, self.G, self.g_opt, best_val=best_val,
                         trained_steps=self.step)
            if self.D is not None:
                d_saver.save("Discriminator", step, self.D, self.d_opt,
                             best_val=best_val, trained_steps=self.step)

    def resume(self, save_path: Optional[str] = None) -> int:
        """Resume from the latest EOE checkpoints of `save_path`, written by the port's
        trainer or the JAX one: G and D, both optimizers' state and the step count (of a
        JAX run, its meta 'step', where the JAX engine resumes). Returns the step (0 with
        nothing there).

        In a group every process reads the chief's files (a shared file system): they
        wait for each other first, D's split head is loaded whole and split again, and a
        checksum of G's parameters must agree across processes, else RuntimeError."""
        save_path = save_path or self.cfg.save_path
        self.init_train()
        self.release_multi_step()  # the optimizers' state is replaced, not copied into
        distributed_barrier("resume")
        with self._whole_head():
            step = self._load_eoe(save_path)
        if process_count() > 1:
            self._verify_resume_consistency()
        return step

    def _load_eoe(self, save_path: str) -> int:
        loaded = Saver(save_path, max_ckpts=3, prefix="EOE_G-").load_weights()
        if loaded is None:
            print("[!] Nothing to resume from")
            return 0
        g_payload, g_meta = loaded
        # load_state_dict copies in place, which bumps each weight's version: the
        # kernel's padded weights are rebuilt from the loaded ones
        load_payload(self.G, self.g_opt, g_payload, generator_state_from_jax)
        self._G_compute = None
        d_loaded = (Saver(save_path, max_ckpts=3, prefix="EOE_D-").load_weights()
                    if self.D is not None else None)
        if d_loaded is not None:
            load_payload(self.D, self.d_opt, d_loaded[0], discriminator_bridge(self.D))
        self.step = int(g_meta["step"])
        print(f"[*] Resumed from step {self.step}")
        return self.step

    def _verify_resume_consistency(self):
        """The JAX ``_verify_multihost_resume_consistency`` (``:1056-1075``): the chief
        writes checkpoints, so a save_path that is not one shared file system leaves the
        other processes on other weights; fail loudly instead."""
        local = sum(float(p.detach().double().abs().sum()) for p in self.G.parameters())
        sums = [None] * process_count()
        dist.all_gather_object(sums, local, group=host_group())
        if not np.allclose(sums, sums[0], rtol=1e-6, atol=1e-6):
            raise RuntimeError(
                "multi-host resume inconsistency: parameter checksums differ across "
                f"processes ({sums}). save_path must be a shared filesystem visible to "
                "every host (chief writes, all read); copy the checkpoint directory to "
                "every host or mount shared storage.")

    def gen_train_samples(self, clean_samples, noisy_samples, z_sample, iteration=None):
        """Write G's output on the sample rows, and once the rows themselves, as wavs
        into save_path."""
        from ..data.wav_io import write_wav

        n = noisy_samples.shape[0]
        zb = z_sample[:n] if z_sample is not None else None
        canvas = self.infer_G(noisy_samples, zb).cpu().numpy()
        dif = noisy_samples - clean_samples
        save_path = self.cfg.save_path
        os.makedirs(save_path, exist_ok=True)
        for m in range(n):
            m_canvas = de_emphasize_np(canvas[m, :, 0], self.preemph)
            write_wav(os.path.join(save_path, f"sample_{iteration}-{m}.wav"),
                      m_canvas, 16000)
            gtruth_path = os.path.join(save_path, f"gtruth_{m}.wav")
            if not os.path.exists(gtruth_path):
                write_wav(gtruth_path,
                          de_emphasize_np(clean_samples[m, :, 0], self.preemph), 16000)
                write_wav(os.path.join(save_path, f"noisy_{m}.wav"),
                          de_emphasize_np(noisy_samples[m, :, 0], self.preemph), 16000)
                write_wav(os.path.join(save_path, f"dif_{m}.wav"),
                          de_emphasize_np(dif[m, :, 0], self.preemph), 16000)

    def close_pool(self):
        """Close and join the evaluation worker pool (kept across evaluate() calls)."""
        if self.pool is not None:
            self.pool.close()
            self.pool.join()
            self.pool = None

    def __del__(self):
        try:
            self.close_pool()
        except Exception:
            pass

    def _eval_z(self, shape, bidx: int) -> Optional[torch.Tensor]:
        """The evaluation z of batch `bidx`: drawn from a generator seeded by (seed + 77,
        step, bidx), so the same on every call at one step."""
        if self.G.no_z:
            return None
        seed = np.random.SeedSequence([self.seed + 77, self.step, bidx]).generate_state(1)
        return self.G.sample_z(shape, torch.Generator().manual_seed(int(seed[0])))

    def evaluate(self, cfg, dloader, log_freq: int, do_noisy: bool = False,
                 max_samples: int = 1):
        """PESQ, SSNR, CSIG, CBAK and COVL of G's output on the first `max_samples`
        batches, scored on a pool of ``cfg.eval_workers`` host processes. The pool is
        spawned, never forked (the parent holds a CUDA context and loader threads); its
        workers import ``metrics`` alone, and the calling script's own body again, so a
        script that trains must keep its work under ``if __name__ == "__main__"``.
        Per-utterance lists by metric; with do_noisy also those of the noisy input.

        In a group every process runs G on the whole batches but scores only the rows r
        with r % processes == its index; the scores are then exchanged over the host
        group (the JAX ``_allgather_eval_results``, ``:1140-1240``) and put back in row
        order, so every process returns the lists that one process would, and takes the
        same early-stop decision."""
        from ..data.loader import host_float32
        from ..metrics import composite_helper

        METRIC_KEYS = ("pesq", "ssnr", "csig", "cbak", "covl")
        evals = {k: [] for k in METRIC_KEYS}
        noisy_evals = {k: [] for k in METRIC_KEYS}
        if self.pool is None:
            self.pool = multiprocessing.get_context("spawn").Pool(cfg.eval_workers)
        nproc, pidx = process_count(), process_index()
        all_ret = []  # (position in one process's lists, result) of the rows scored here
        position = 0
        for bidx, batch in enumerate(dloader, start=1):
            clean = host_float32(batch["clean"])  # (B, T)
            noisy = host_float32(batch["noisy"])
            # only the valid rows are scored: the ragged final batch is padded with
            # copies of its last row, with mask 0
            bmask = np.asarray(batch.get("mask", np.ones(clean.shape[0])))
            n_valid = int(bmask.sum())
            z = self._eval_z((*noisy.shape, 1), bidx)
            Genh = self.infer_G(noisy[..., None], z)[..., 0].cpu().numpy()
            clean, noisy, Genh = clean[:n_valid], noisy[:n_valid], Genh[:n_valid]
            clean_de = de_emphasize_np(clean, self.preemph)
            genh_de = de_emphasize_np(Genh, self.preemph)
            beg_t = timeit.default_timer()
            rows = [i for i in range(n_valid) if i % nproc == pidx]
            noisy_de = de_emphasize_np(noisy, self.preemph) if do_noisy else None
            args = [(clean_de[i], genh_de[i], noisy_de[i] if do_noisy else None)
                    for i in rows]
            all_ret.extend(zip((position + i for i in rows),
                               self.pool.map(composite_helper, args)))
            position += n_valid
            end_t = timeit.default_timer()
            print(f"Time to process eval with {len(rows)} samples : {end_t - beg_t} s")
            if bidx >= max_samples:
                break
        if nproc > 1:
            parts = [None] * nproc
            dist.all_gather_object(parts, all_ret, group=host_group())
            all_ret = [r for part in parts for r in part]
        all_ret = [r for _, r in sorted(all_ret, key=lambda item: item[0])]

        def fill(ret_dict, in_dict):
            for k, v in in_dict.items():
                ret_dict[k].append(v)

        if do_noisy:
            for eval_, noisy_eval_ in all_ret:
                fill(evals, eval_)
                fill(noisy_evals, noisy_eval_)
            return evals, noisy_evals
        for eval_ in all_ret:
            fill(evals, eval_)
        return evals


class _NoStep:
    """An optimizer that takes no step: the fake copy of an engine counts the FLOPs of
    the convolutions and matmuls alone, of which an optimizer step has none."""

    def zero_grad(self, set_to_none: bool = True):
        pass

    def step(self):
        pass


def _fake_module(module: torch.nn.Module, mode) -> torch.nn.Module:
    """A copy of `module` whose parameters and buffers are fake CPU tensors of `mode`:
    the same shapes, no data, nothing copied from the card."""
    memo = {}
    with mode:
        for t in list(module.parameters()) + list(module.buffers()):
            fake = torch.empty(t.shape, dtype=t.dtype, device="cpu")
            memo[id(t)] = (torch.nn.Parameter(fake, t.requires_grad)
                           if isinstance(t, torch.nn.Parameter) else fake)
    return copy.deepcopy(module, memo)


def _fake_engine(engine: "SEGAN", mode) -> "SEGAN":
    """A shallow copy of `engine` on fake CPU tensors of `mode` for counting a step's
    FLOPs (the kernel's wrapper takes its plain version there, which the counter sees):
    optimizers that take no step, streams of draws of its own, no graph, no pool."""
    fake = copy.copy(engine)
    fake.device = torch.device("cpu")
    fake._z_train, fake._phase_train = torch.Generator(), torch.Generator()
    fake.G = _fake_module(engine.G, mode)
    fake.D = _fake_module(engine.D, mode) if engine.D is not None else None
    fake.g_opt = _NoStep()
    fake.d_opt = _NoStep() if engine.d_opt is not None else None
    fake._G_compute = fake._multi = fake.pool = fake.writer = None
    fake.grid = fake._data = fake._model = fake._n = None  # this rank's work, no collective
    for model in (fake.G, fake.D):
        for m in (model.modules() if model is not None else ()):
            if isinstance(m, BatchNorm1d):
                m.axis = None
            if getattr(m, "tp", None) is not None:
                m.tp = None
    return fake

