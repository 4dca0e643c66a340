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

import copy
import multiprocessing
import os
import signal
import threading
import timeit
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import conv as conv_ops
from ..ops.conv import at_least_fp32
from ..ops.signal import de_emphasize_np
from ..parallel.inference import chunk_grid, overlap_add
from ..utils.checkpoint import Saver, load_discriminator, load_generator
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
        self.pool = None  # the evaluation worker pool, kept across epochs
        self.writer = None
        self._preempted = False

    def g_load_pretrained(self, ckpt_path: str):
        """Load G strictly from a reference-format torch .ckpt or a JAX npz checkpoint."""
        load_generator(self.G, ckpt_path)
        self._G_compute = None

    def d_load_pretrained(self, ckpt_path: str):
        """Load D (built first if need be) strictly, as G is loaded."""
        self.init_train()
        load_discriminator(self.D, ckpt_path)

    def get_n_params(self) -> int:
        """Parameters of G and D."""
        self.init_train()
        return sum(p.numel() for m in (self.G, self.D) for p in m.parameters())

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
        self._seed_step_streams(self.seed)

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
        self.step += 1
        metrics = {"d_real": d_real, "d_fake": d_fake, "g_adv": g_adv, "g_l1": g_l1}
        return metrics, Genh.detach().float(), z

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
        iterations, the L1 schedule, log points, checkpoint names and early stop."""
        from ..data.loader import device_prefetch
        from ..utils.logging import StepTimer, TrainLogger

        unported = unported_options(cfg)
        if unported:
            raise NotImplementedError(f"not ported yet: {', '.join(unported)}")
        self.writer = TrainLogger(os.path.join(cfg.save_path, "train"))
        self.init_train()
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
        evals = {}
        noisy_evals = {}
        noisy_samples = None
        clean_samples = None
        z_sample = None
        patience = cfg.patience
        best_val_obj = 0
        self._seed_step_streams(self.seed + start_step)
        restore_sig = self._install_preempt_handler()
        for epoch in range(start_epoch, cfg.epoch + 1):
            timer.start()
            stream = device_prefetch(iter(dloader), self.device)
            bidx = 0
            while bidx < num_batches:
                prev_bidx = bidx
                if epoch >= l1_dec_epoch and l1_weight > 0:
                    l1_weight = max(0.0, l1_weight - l1_dec_step)
                batch = next(stream)
                clean = batch["clean"][..., None]  # (B, T, 1), on the device
                noisy = batch["noisy"][..., None]
                metrics, Genh, z = self.train_step(clean, noisy, batch.get("mask"),
                                                   l1_weight)
                bidx += 1
                if noisy_samples is None:  # from the host copy: no device sync
                    noisy_samples = batch["host"]["noisy"][:20, :, None].copy()
                    clean_samples = batch["host"]["clean"][:20, :, None].copy()
                    if z is not None:
                        z_sample = z[:20].clone()
                timer.stop()
                timer.start()
                if bidx // log_freq != prev_bidx // log_freq or bidx >= num_batches:
                    # the losses are read on the host here only: a sync point
                    m = {k: float(v) for k, v in metrics.items()}
                    print(
                        f"(Iter {iteration}) Batch {bidx}/{num_batches} (Epoch {epoch})"
                        f" d_real:{m['d_real']:.4f}, d_fake:{m['d_fake']:.4f},"
                        f" g_adv:{m['g_adv']:.4f}, g_l1:{m['g_l1']:.4f}"
                        f" l1_w: {l1_weight:.2f}, btime: {timer.last:.4f} s,"
                        f" mbtime: {timer.mean:.4f} s", flush=True)
                    self.writer.scalar("D_real", m["d_real"], iteration)
                    self.writer.scalar("D_fake", m["d_fake"], iteration)
                    self.writer.scalar("G_adv", m["g_adv"], iteration)
                    self.writer.scalar("G_l1", m["g_l1"], iteration)
                    self.writer.histogram("Gz", Genh, iteration)
                    self.writer.histogram("clean", clean, iteration)
                    self.writer.histogram("noisy", noisy, iteration)
                    self.writer.weight_norms(self.G, "Gtotal", iteration)
                    self.writer.weight_norms(self.D, "Dtotal", iteration)
                    if not cfg.no_train_gen:
                        self.gen_train_samples(clean_samples, noisy_samples, z_sample,
                                               iteration=iteration)
                iteration += 1
                if self._preempted:
                    break

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
        for sv in (eoe_g_saver, eoe_d_saver, best_saver_g, best_saver_d):
            sv.flush()  # every checkpoint byte on disk before train() returns
        self.close_pool()
        self.writer.close()

    def save(self, g_saver: Saver, d_saver: Saver, step: int, best_val: bool = False):
        """G and D with their optimizers' state, named after `step` (the loop's
        iteration); each payload records the train steps taken."""
        g_saver.save("Generator", step, self.G, self.g_opt, best_val=best_val,
                     trained_steps=self.step)
        if self.D is not None:
            d_saver.save("Discriminator", step, self.D, self.d_opt, best_val=best_val,
                         trained_steps=self.step)

    def resume(self, save_path: Optional[str] = None) -> int:
        """Resume from the latest EOE checkpoints of `save_path`: G and D, both
        optimizers' state and the step count. Returns the step (0 with nothing there)."""
        save_path = save_path or self.cfg.save_path
        self.init_train()
        loaded = Saver(save_path, max_ckpts=3, prefix="EOE_G-").load_weights()
        if loaded is None:
            print("[!] Nothing to resume from")
            return 0
        g_payload, g_meta = loaded
        # load_state_dict copies in place, which bumps each weight's version: the
        # kernel's padded weights are rebuilt from the loaded ones
        self.G.load_state_dict(g_payload["state_dict"], strict=True)
        if "optimizer" in g_payload:
            self.g_opt.load_state_dict(g_payload["optimizer"])
        self._G_compute = None
        d_loaded = Saver(save_path, max_ckpts=3, prefix="EOE_D-").load_weights()
        if d_loaded is not None:
            d_payload, _ = d_loaded
            self.D.load_state_dict(d_payload["state_dict"], strict=True)
            if "optimizer" in d_payload:
                self.d_opt.load_state_dict(d_payload["optimizer"])
        self.step = int(g_meta["step"])
        print(f"[*] Resumed from step {self.step}")
        return self.step

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
        Per-utterance lists by metric; with do_noisy also those of the noisy input."""
        from ..metrics import composite_helper

        METRIC_KEYS = ("pesq", "ssnr", "csig", "cbak", "covl")
        evals = {k: [] for k in METRIC_KEYS}
        noisy_evals = {k: [] for k in METRIC_KEYS}
        if self.pool is None:
            self.pool = multiprocessing.get_context("spawn").Pool(cfg.eval_workers)
        all_ret = []
        for bidx, batch in enumerate(dloader, start=1):
            clean = np.asarray(batch["clean"], np.float32)  # (B, T)
            noisy = np.asarray(batch["noisy"], np.float32)
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
            if do_noisy:
                noisy_de = de_emphasize_np(noisy, self.preemph)
                args = [(clean_de[i], genh_de[i], noisy_de[i]) for i in range(n_valid)]
            else:
                args = [(clean_de[i], genh_de[i], None) for i in range(n_valid)]
            all_ret.extend(self.pool.map(composite_helper, args))
            end_t = timeit.default_timer()
            print(f"Time to process eval with {n_valid} samples : {end_t - beg_t} s")
            if bidx >= max_samples:
                break

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


def unported_options(cfg) -> List[str]:
    """The options of ``cfg`` set to something the port does not run yet, as CLI flags;
    the trainer raises on any of them rather than ignore it."""
    checks = [
        ("--wsegan", cfg.wsegan),
        ("--aewsegan", getattr(cfg, "aewsegan", False)),
        ("--h5", cfg.h5),
        ("--noises_dir", getattr(cfg, "noises_dir", None)),
        ("--shuffle_buffer", getattr(cfg, "shuffle_buffer", 0)),
        ("--steps_per_call", getattr(cfg, "steps_per_call", 1) > 1),
        ("--profile", getattr(cfg, "profile", False)),
        ("--loader_dtype", getattr(cfg, "loader_dtype", None)),
        ("--dp", (cfg.dp or 1) > 1),
        ("--mp", (getattr(cfg, "mp", 1) or 1) > 1),
        ("--coordinator", getattr(cfg, "coordinator", None)),
        ("--num_processes", (getattr(cfg, "num_processes", None) or 1) > 1),
        ("--random_scale", list(cfg.random_scale) != [1]),
        ("--preemph_norm", cfg.preemph_norm),
    ]
    return [flag for flag, value in checks if value]
