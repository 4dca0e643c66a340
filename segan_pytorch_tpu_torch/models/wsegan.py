"""WSEGAN (whispered to voiced speech) and AEWSEGAN (its autoencoder ablation): the
counterparts of ``segan_pytorch_tpu/models/wsegan.py``.

What WSEGAN changes from SEGAN:
- the train step (``make_wsegan_train_step``): D's cost is BCE-with-logits under
  ``vanilla_gan``, else the MSE; besides the real and fake pairs D judges the misaligned
  one (clean against clean[perm], ``misalign_pair``) and the interfered one (clean plus a
  square wave, ``interf_pair``), its loss weighted 1/2, 1/3 or 1/4 as pairs are added;
  every D pass runs in training mode, so spectral norm's u and v advance in each; G's
  objective through the updated D adds an STFT power loss (``pow_weight``) and an L1 term
  on the utterances whose name holds 'additive';
- Xavier-uniform init of every weight of G and D (``apply_wsegan_weights_init``);
- the loop is driven by iterations (epochs x batches), draws batches on without end, has
  no L1 decay and no validation, and its checkpoints are named after the steps taken;
- ``generate`` pads an utterance to ``make_div_n(1024)`` and runs G once over it, with a
  fresh z per utterance.

AEWSEGAN trains G alone on the L1 (or MSE) of its output, with Adam (0.5, 0.9) or RMSprop,
and scores the validation set by spectral distortion (``evaluate_sd``).

The step's draws (z, the phase shifts, the misalignment permutation and the square waves)
come from the engine's seeded streams, as SEGAN's do; the tests pass in the JAX step's.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import conv as conv_ops
from ..ops.conv import at_least_fp32
from ..ops.signal import de_emphasize_np, div_n_len, make_div_n_np
from ..ops.stft import power_spectrum_db
from ..parallel import sharding
from ..utils.checkpoint import Saver
from .discriminator import d_input
from .segan import SEGAN, build_optimizer, masked_bce_logits, masked_mean, masked_mse

INTERF_FREQS = (250.0, 1000.0, 4000.0)
INTERF_AMPS = (0.01, 0.05, 0.1, 1.0)


def apply_wsegan_weights_init(model: torch.nn.Module, generator: torch.Generator):
    """Xavier-uniform every weight of two or more dimensions (upstream's
    ``wsegan_weights_init``): convs, deconvs and Linears, their 'weight_orig' under spectral
    norm, U(+-sqrt(6 / (fan_in + fan_out))) with torch's fans, which for a transposed
    conv's (Cin, Cout, K) are those of the JAX ``xavier_uniform_convT``. Slopes, biases,
    alpha skips and norms keep their values. Drawn on the CPU from `generator`."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("weight", "weight_orig") and p.dim() >= 2:
                receptive = math.prod(p.shape[2:])
                a = math.sqrt(6.0 / ((p.shape[0] + p.shape[1]) * receptive))
                p.copy_(torch.empty(p.shape).uniform_(-a, a, generator=generator))


def square_waves(f: torch.Tensor, a: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T, 1) square waves a * square(2 pi f t) of the frequencies f (B,) and
    amplitudes a (B,) on upstream's grid t = linspace(0, 2, 32000)[:T]."""
    t = torch.linspace(0.0, 2.0, 32000)[:T]
    phase = torch.remainder(f[:, None] * t[None, :], 1.0)
    return (a[:, None] * torch.where(phase < 0.5, 1.0, -1.0))[:, :, None]


def square_wave_batch(bsz: int, T: int, generator: torch.Generator) -> torch.Tensor:
    """``square_waves`` of random frequency (250, 1000 or 4000 Hz) and amplitude (0.01,
    0.05, 0.1 or 1), drawn on the CPU from `generator` (the JAX ``_square_wave_batch``)."""
    f = torch.tensor(INTERF_FREQS)[torch.randint(0, len(INTERF_FREQS), (bsz,),
                                                 generator=generator)]
    a = torch.tensor(INTERF_AMPS)[torch.randint(0, len(INTERF_AMPS), (bsz,),
                                                generator=generator)]
    return square_waves(f, a, T)


def additive_mask(uttnames: Sequence[str]) -> np.ndarray:
    """1.0 for each utterance whose name holds 'additive', else 0.0 (upstream's L1 term
    takes those alone)."""
    return np.asarray([1.0 if "additive" in u else 0.0 for u in uttnames], np.float32)


class WSEGAN(SEGAN):
    """WSEGAN: the SEGAN engine with WSEGAN's init, step, loop and enhancement (see the
    module docstring)."""

    name = "WSEGAN"

    def __init__(self, cfg, generator=None, device=None, seed: Optional[int] = None,
                 discriminator=None):
        super().__init__(cfg, generator=generator, device=device, seed=seed,
                         discriminator=discriminator)
        if generator is None:  # a G of the engine's own: Xavier from seed + 5
            apply_wsegan_weights_init(self.G, torch.Generator().manual_seed(self.seed + 5))
        self.misalign_pair = cfg.misalign_pair
        self.interf_pair = cfg.interf_pair
        self.pow_weight = cfg.pow_weight
        self.n_fft = cfg.n_fft
        self._cost = masked_bce_logits if cfg.vanilla_gan else masked_mse

    def _build_train(self):
        """SEGAN's, with D (when the engine builds it) Xavier-initialised from seed + 6;
        the optimizers are ``cfg.opt`` with Adam's betas (0, 0.9), as upstream's."""
        built = self.D is None
        super()._build_train()
        if built:
            apply_wsegan_weights_init(self.D, torch.Generator().manual_seed(self.seed + 6))

    def _d_pairs(self, clean_c, noisy_c, fake, perm, squares):
        """D's judgments of the step: [(input, label, loss name)] and the loss weight."""
        pairs = [(d_input(clean_c, noisy_c), 1.0, "d_real"),
                 (d_input(fake, noisy_c), 0.0, "d_fake")]
        d_weight = 1.0 / 2
        if self.misalign_pair:
            # perm is of the global batch: under a grid a row's partner may sit on
            # another rank
            partner = (clean_c[perm] if self.grid is None else
                       sharding.gather_cat(clean_c, self._data)[
                           perm[self.grid.rows(clean_c.shape[0])]])
            pairs.append((d_input(clean_c, partner), 0.0, "d_fake_shuf"))
            d_weight = 1.0 / 3
        if self.interf_pair:
            pairs.append((d_input(clean_c + squares.to(clean_c.dtype), noisy_c), 0.0,
                          "d_fake_inter"))
            d_weight = 1.0 / 4
        return pairs, d_weight

    def _d_update(self, clean_c, noisy_c, fake, mask, phase, perm=None, squares=None):
        """D's passes over every pair (each advancing spectral norm's u and v), the
        weighted sum of their costs, one D step. Returns (d_loss, {name: cost})."""
        pairs, d_weight = self._d_pairs(clean_c, noisy_c, fake, perm, squares)
        losses: Dict[str, torch.Tensor] = {}
        total = 0.0
        for (x, label, name), ph in zip(pairs, phase):
            y, _ = self._run(self.D, x, mask=mask, phase=ph)
            losses[name] = self._cost(y, label, mask, self._n)
            total = total + losses[name]
        d_loss = d_weight * total
        d_loss.backward()
        self._reduce_grads(self.D)
        self.d_opt.step()
        return d_loss.detach(), {k: v.detach() for k, v in losses.items()}

    def _g_update(self, Genh, clean, noisy_c, mask, phase, l1_weight: torch.Tensor,
                  amask=None):
        """G's objective through the updated D: the adversarial cost, pow_weight x the
        masked mean |P(Genh) - P(clean)| of the dB power spectra, and l1_weight x the
        masked mean |Genh - clean| over the 'additive' rows (0 when l1_weight is 0);
        differentiated with respect to Genh, then through G; one G step."""
        genh = Genh.detach().requires_grad_()
        d_fake_, _ = self._run(self.D, d_input(genh, noisy_c), mask=mask, phase=phase)
        g_adv = self._cost(d_fake_, 1.0, mask, self._n)
        genh32 = at_least_fp32(genh)
        clean_pow = power_spectrum_db(clean[..., 0], self.n_fft)
        genh_pow = power_spectrum_db(genh32[..., 0], self.n_fft)
        pow_loss = self.pow_weight * masked_mean((genh_pow - clean_pow).abs(), mask,
                                                 self._n)
        am = amask.view(-1, 1, 1)
        den_loss = l1_weight * masked_mean((genh32 * am - clean * am).abs(), mask, self._n)
        # 0 unless the weight is positive, decided on the device as in JAX
        den_loss = torch.where(l1_weight > 0, den_loss, torch.zeros_like(den_loss))
        g_cost = g_adv + pow_loss + den_loss
        (d_genh,) = torch.autograd.grad(g_cost, genh)
        Genh.backward(d_genh)
        self._reduce_grads(self.G)
        self.g_opt.step()
        self._G_compute = None
        return {k: v.detach() for k, v in (("g_loss", g_cost), ("g_adv", g_adv),
                                          ("pow_loss", pow_loss),
                                          ("den_loss", den_loss))}

    def n_d_passes(self) -> int:
        """D passes of a step: real, fake, [misaligned], [interfered], and G's."""
        return 3 + int(self.misalign_pair) + int(self.interf_pair)

    batch_keys = ("clean", "noisy", "mask", "additive_mask")

    def _inputs(self, clean, noisy, mask=None, additive_mask=None):
        """SEGAN's, and the additive mask (None: no row) on the device in fp32."""
        x = super()._inputs(clean, noisy, mask)
        x["additive_mask"] = (
            torch.zeros(x["clean"].shape[0], device=self.device) if additive_mask is None
            else torch.as_tensor(additive_mask).to(self.device, torch.float32))
        return x

    def _draw(self, B: int, T: int, z=None, phase=None, perm=None, squares=None):
        """A step's draws, each the given one or the next from the engine's streams: z
        (on the device), the phase shifts of every D pass, then the misalignment
        permutation (B,) and the square waves (B, T, 1), each on the host and only with
        its pair. Under a grid each is drawn (or given) for the global batch; the
        permutation stays whole (it indexes the global batch) and the rest keep this
        rank's rows."""
        draws = super()._draw(B, T, z=z, phase=phase)
        Bg = B * self._dp()
        if perm is None and self.misalign_pair:
            perm = torch.randperm(Bg, generator=self._phase_train)
        if squares is None and self.interf_pair:
            squares = square_wave_batch(Bg, T, self._phase_train)
        draws["perm"] = (torch.as_tensor(perm, dtype=torch.long)
                         if perm is not None else None)
        draws["squares"] = (self._local(torch.as_tensor(squares, dtype=torch.float32), B)
                            if squares is not None else None)
        return draws

    def _body(self, x, l1_weight, draws):
        """The WSEGAN step on device tensors alone (the host's perm and squares of an
        eager step are copied over first). Returns (metrics, Genh)."""
        cdt = self.compute_dtype
        clean, noisy, mask, z = x["clean"], x["noisy"], x["mask"], draws["z"]
        phase = draws["phase"]
        if phase is None:  # a D without phase shift
            phase = [None] * self.n_d_passes()
        perm, squares = (draws[k].to(clean.device) if draws[k] is not None else None
                         for k in ("perm", "squares"))
        self._n = self._count(mask)
        self.g_opt.zero_grad(set_to_none=True)
        self.d_opt.zero_grad(set_to_none=True)
        self.G.train()
        self.D.train()
        try:
            with conv_ops.full_precision(cdt):
                noisy_c = noisy.to(cdt)
                Genh = self._g_forward(noisy_c, z.to(cdt) if z is not None else None)
                d_loss, d_losses = self._d_update(clean.to(cdt), noisy_c, Genh.detach(),
                                                  mask, phase[:-1], perm, squares)
                g_metrics = self._g_update(Genh, clean, noisy_c, mask, phase[-1],
                                           l1_weight, x["additive_mask"])
        finally:
            self.G.eval()
            self.D.eval()
        metrics = {"d_loss": d_loss, **g_metrics, **d_losses}
        return self._sum_metrics(metrics), Genh.detach().float()

    def train_step(self, clean, noisy, mask=None, additive_mask=None,
                   l1_weight: float = 100.0, z=None, phase=None, perm=None, squares=None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
        """One WSEGAN step on clean and noisy (B, T, 1) with a (B,) mask (None: all
        rows) and additive_mask (None: no row).

        z (B, T', z_dim), phase ((n_d_passes(), n_layers, 2) of (shift, right): real,
        fake, [misaligned], [interfered], G's pass), perm (B,) and squares (B, T, 1) come
        from the engine's streams when None. Returns (metrics, Genh, z): metrics
        'd_loss', 'g_loss', 'g_adv', 'pow_loss', 'den_loss', 'd_real', 'd_fake' and, with
        their pairs, 'd_fake_shuf' and 'd_fake_inter', as 0-d fp32 tensors on the device;
        Genh (B, T, 1) fp32."""
        self.init_train()
        x = self._inputs(clean, noisy, mask, additive_mask)
        draws = self._draw(*x["clean"].shape[:2], z=z, phase=phase, perm=perm,
                           squares=squares)
        metrics, Genh = self._body(x, self._l1(l1_weight), draws)
        self.step += 1
        return metrics, Genh, draws["z"]

    # -- the training run -----------------------------------------------------
    def _batches(self, dloader, with_additive: bool):
        """The loader's batches without end, on the device one ahead; with the additive
        mask of each batch's utterance names."""
        from ..data.loader import device_prefetch

        def forever():
            while True:
                for b in dloader:
                    if with_additive:
                        b["additive_mask"] = additive_mask(b["uttname"])
                    yield b

        return device_prefetch(forever(), self.device)

    def _log_skip_alphas(self, iteration: int):
        """Histograms of G's learnt skip scales (upstream's model.py:720-727)."""
        for name, p in self.G.named_parameters():
            if name.startswith("alpha_") and name.endswith(".skip_k"):
                self.writer.histogram(f"skip_{name.split('.')[0]}", p, iteration)

    def _run_loop(self, cfg, dloader, step_fn, log_fn, savers, va_dloader=None):
        """The iteration-driven loop of both engines: ``cfg.epoch`` x batches iterations,
        less the steps already taken (a resumed run runs only the rest); ``step_fn(
        batches)`` -> (metrics, Genh, z) of one step per batch given, one call;
        ``log_fn(iteration, total, num_batches, metrics, Genh, batch, timer)`` at every
        ``log_freq``-th; EOE saves at epoch ends (every ``eoe_save_every``-th and the
        last); SIGTERM saves and stops. With ``cfg.steps_per_call`` S > 1 each call takes
        S batches (``train_step_multi``), but never across an epoch's end nor past the
        last iteration: those run single steps; the log and samples take the last batch
        of a group. ``--profile`` is not read here, as in JAX. In a group each rank takes
        its S batches from its data shard (S is 1 only for processes launched apart:
        ``_steps_per_call``), the chief alone writes samples and checkpoints, and every
        process saves together (``save`` puts D's split head together first)."""
        from ..data.loader import host_float32
        from ..utils.logging import StepTimer

        num_batches = len(dloader)
        total_iters = cfg.epoch * num_batches
        iteration = self.step
        self._seed_step_streams(self.seed + iteration)
        stream = self._batches(dloader, with_additive=self.D is not None)
        samples = None
        timer = StepTimer()
        restore_sig = self._install_preempt_handler()
        S = self._steps_per_call(cfg)
        if S > 1:
            # before the first step: every step of the run, single or grouped, keeps one
            # optimizer mode, and a backend that cannot be captured refuses before a batch
            self.prepare_multi_step(S)
        timer.start()
        try:
            while iteration < total_iters:
                prev = iteration
                to_epoch_end = num_batches - iteration % num_batches
                n_sub = S if min(total_iters - iteration, to_epoch_end) >= S else 1
                batches = [next(stream) for _ in range(n_sub)]
                metrics, Genh, z = step_fn(batches)
                batch = batches[-1]
                iteration += n_sub
                timer.stop()
                timer.start()
                if samples is None:  # from the host copy: no device sync
                    samples = (host_float32(batch["host"]["clean"][:20])[..., None],
                               host_float32(batch["host"]["noisy"][:20])[..., None],
                               z[:20].clone() if z is not None else None)

                def crossed(every: int) -> bool:
                    return iteration // every != prev // every

                if crossed(self._log_freq):
                    log_fn(iteration, total_iters, num_batches, metrics, Genh, batch,
                           timer, va_dloader)
                    if not cfg.no_train_gen and self._chief():
                        self.gen_train_samples(samples[0], samples[1], samples[2],
                                               iteration=iteration)
                if crossed(num_batches):
                    epoch = iteration // num_batches
                    if epoch % max(1, getattr(cfg, "eoe_save_every", 1)) == 0 \
                            or iteration >= total_iters:
                        self.save(*savers, iteration)
                if self._preempted:
                    print(f"[!] preempted at iteration {iteration}: saving checkpoint "
                          "and stopping")
                    self.save(*savers, iteration)
                    break
        finally:
            restore_sig()
            self.release_multi_step()
        for sv in savers:
            if sv is not None:
                sv.flush()

    def train(self, cfg, dloader, l1_init: float = 100.0, l1_dec_step: float = 1e-5,
              l1_dec_epoch: int = 100, log_freq: int = 50, va_dloader=None):
        """The WSEGAN loop (upstream's model.py:541-753, the JAX ``WSEGAN.train``): a
        fixed L1 weight, log points with the power-spectrum histograms, EOE saves of G and
        D named after the steps taken. ``l1_dec_step``, ``l1_dec_epoch`` and
        ``va_dloader`` are taken for the signature's sake and unused, as in JAX."""
        from ..utils.logging import TrainLogger

        self.init_train()
        self.writer = TrainLogger(os.path.join(cfg.save_path, "train"),
                                  enabled=self._chief())
        self._log_freq = log_freq
        savers = (Saver(cfg.save_path, max_ckpts=3, prefix="EOE_G-", async_write=True),
                  Saver(cfg.save_path, max_ckpts=3, prefix="EOE_D-", async_write=True))

        def step(batches):
            if len(batches) > 1:
                return self.train_step_multi(
                    *self._stack_group(batches, ("additive_mask",)),
                    l1_w_s=[l1_init] * len(batches))[1:]
            b = batches[0]
            return self.train_step(b["clean"][..., None], b["noisy"][..., None],
                                   b.get("mask"), b["additive_mask"], l1_init)

        def log(iteration, total, num_batches, metrics, Genh, batch, timer, _va):
            m = {k: float(v) for k, v in metrics.items()}  # waits for the step
            print(f"Iter {iteration}/{total} ({num_batches} bpe) d_loss:{m['d_loss']:.4f},"
                  f" g_loss: {m['g_loss']:.4f}, pow_loss: {m['pow_loss']:.4f}, den_loss: "
                  f"{m['den_loss']:.4f} btime: {timer.last:.4f} s, mbtime: "
                  f"{timer.mean:.4f} s", flush=True)
            w = self.writer
            w.scalar("D_loss", m["d_loss"], iteration)
            w.scalar("G_loss", m["g_loss"], iteration)
            w.scalar("G_adv_loss", m["g_adv"], iteration)
            w.scalar("G_pow_loss", m["pow_loss"], iteration)
            clean = batch["clean"]
            w.histogram("clean_mod_pow", power_spectrum_db(clean, self.n_fft), iteration)
            w.histogram("Genh_mod_pow", power_spectrum_db(Genh[..., 0], self.n_fft),
                        iteration)
            w.histogram("Gz", Genh, iteration)
            w.histogram("clean", clean, iteration)
            w.histogram("noisy", batch["noisy"], iteration)
            w.weight_norms(self.G, "Gtotal", iteration)
            w.weight_norms(self.D, "Dtotal", iteration)
            self._log_skip_alphas(iteration)

        self._run_loop(cfg, dloader, step, log, savers)
        self.writer.close()

    # -- enhancement ----------------------------------------------------------
    def generate(self, inwav: np.ndarray, z: Optional[np.ndarray] = None,
                 overlap: float = 0.0):
        """Enhance one normalized, pre-emphasized waveform in one G pass over it, padded
        by ``make_div_n(1024)`` (upstream's model.py:755-766). Returns (enhanced wav (T,),
        hall): hall is G's dict of hidden tensors (B = 1), as ``infer_G`` returns them.
        `overlap` is taken for SEGAN's signature and unused: there are no chunks."""
        wav = np.asarray(inwav, np.float32).reshape(-1)
        x = make_div_n_np(wav, 1024)[None, :, None]
        out, hall = self.infer_G(x, self._z_row(z, x.shape[1]), ret_hid=True)
        return de_emphasize_np(out[0, : wav.shape[0], 0].cpu().numpy(), self.preemph), hall

    def generate_batch(self, inwavs: Sequence[np.ndarray], overlap: float = 0.0,
                       z: Optional[Sequence[np.ndarray]] = None) -> List[tuple]:
        """Enhance many waveforms; equals one generate() per waveform in order. The
        utterances are grouped by their padded length and each group runs as one G pass
        (rows must share the padded length for the outputs to equal generate()'s); the
        i-th utterance takes the i-th z draw, or z[i], whatever its group. Each result's
        hall holds its own row (B = 1)."""
        if inwavs is None or len(inwavs) == 0:
            return []
        if z is not None and len(z) != len(inwavs):
            raise ValueError(f"{len(inwavs)} waveforms but {len(z)} z rows")
        wavs = [np.asarray(w, np.float32).reshape(-1) for w in inwavs]
        lengths = [div_n_len(w.shape[0], 1024) for w in wavs]
        z_rows = [self._z_row(None if z is None else z[i], L) for i, L in enumerate(lengths)]
        groups: Dict[int, List[int]] = {}
        for i, L in enumerate(lengths):
            groups.setdefault(L, []).append(i)
        results: List[Optional[tuple]] = [None] * len(wavs)
        for L, idxs in sorted(groups.items()):
            x = np.zeros((len(idxs), L, 1), np.float32)
            for r, i in enumerate(idxs):
                x[r, : wavs[i].shape[0], 0] = wavs[i]
            zb = None if self.G.no_z else torch.cat([z_rows[i] for i in idxs], dim=0)
            out, hall = self.infer_G(x, zb, ret_hid=True)
            out = out.cpu().numpy()
            for r, i in enumerate(idxs):
                c = de_emphasize_np(out[r, : wavs[i].shape[0], 0], self.preemph)
                hall_i = {k: (v[r: r + 1] if v is not None else None)
                          for k, v in hall.items()}
                results[i] = (c, hall_i)
        return results


class AEWSEGAN(WSEGAN):
    """The autoencoder ablation: G alone, trained on the L1 of its output (the MSE when
    ``reg_loss`` is 'mse_loss', or as a legacy train.opts' boolean ``l1_loss`` says), no
    D. ``deconv_impl`` defaults to 'edge-blocked' in a copy of the config, as the JAX
    engine records it; it is a TPU lowering and has no effect here."""

    name = "AEWSEGAN"

    def __init__(self, cfg, generator=None, device=None, seed: Optional[int] = None):
        if getattr(cfg, "deconv_impl", None) is None:
            resolved = dataclasses.replace(cfg, deconv_impl="edge-blocked")
            resolved._unknown = getattr(cfg, "_unknown", {})
            cfg = resolved
        super().__init__(cfg, generator=generator, device=device, seed=seed)
        self.D = None
        if cfg.legacy_l1_loss is not None:
            self.use_l1 = bool(cfg.legacy_l1_loss)
        else:
            self.use_l1 = cfg.reg_loss == "l1_loss"

    def _build_train(self):
        """G's optimizer, Adam (0.5, 0.9) (upstream's model.py:790) or RMSprop, and the
        engine's z stream."""
        cfg = self.cfg
        betas = (0.5, 0.9)
        self.g_opt = build_optimizer(cfg.opt, cfg.g_lr, self.G.parameters(), betas=betas)
        self._seed_step_streams(self.seed)

    def get_n_params(self) -> int:
        return sum(p.numel() for p in self.G.parameters())

    batch_keys = SEGAN.batch_keys
    _inputs = SEGAN._inputs

    def _draw(self, B: int, T: int, z=None):
        """The step's one draw: z (on the device), the given one or the engine's next;
        under a grid of the global batch, this rank's rows kept."""
        if z is None and not self.G.no_z:
            z = self.G.sample_z((B * self._dp(), T, 1), self._z_train)
        z = self._local(torch.as_tensor(z), B) if z is not None else None
        return {"z": z.to(self.device, torch.float32) if z is not None else None}

    def _body(self, x, l1_weight, draws):
        """The G step on device tensors alone. Returns ({'loss'}, Genh)."""
        cdt = self.compute_dtype
        clean, noisy, mask, z = x["clean"], x["noisy"], x["mask"], draws["z"]
        self._n = self._count(mask)
        self.g_opt.zero_grad(set_to_none=True)
        self.G.train()
        try:
            with conv_ops.full_precision(cdt):
                Genh = self._g_forward(noisy.to(cdt), z.to(cdt) if z is not None else None)
                diff = at_least_fp32(Genh) - clean
                loss = masked_mean(diff.abs() if self.use_l1 else diff.square(), mask,
                                   self._n)
                loss.backward()
                self._reduce_grads(self.G)
                self.g_opt.step()
        finally:
            self.G.eval()
        self._G_compute = None
        return self._sum_metrics({"loss": loss.detach()}), Genh.detach().float()

    def train_step(self, clean, noisy, mask=None, l1_weight: float = 100.0, z=None):
        """One G step on the masked mean |Genh - clean| (or its square). Returns
        ({'loss'}, Genh (B, T, 1) fp32, z); l1_weight is taken for the signature's sake
        (the JAX step's) and unused."""
        self.init_train()
        x = self._inputs(clean, noisy, mask)
        draws = self._draw(*x["clean"].shape[:2], z=z)
        metrics, Genh = self._body(x, self._l1(l1_weight), draws)
        self.step += 1
        return metrics, Genh, draws["z"]

    def evaluate_sd(self, cfg, dloader, max_samples: int = 1) -> float:
        """Spectral distortion in dB, the mean |P(Genh) - P(clean)| of the dB power
        spectra over the first `max_samples` batches (all rows, as the JAX one takes
        them); z as ``evaluate``'s, fixed per step."""
        from ..data.loader import host_float32

        sds = []
        for bidx, batch in enumerate(dloader, start=1):
            noisy = host_float32(batch["noisy"])[..., None]
            clean = torch.as_tensor(host_float32(batch["clean"])).to(self.device)
            Genh = self.infer_G(noisy, self._eval_z(noisy.shape, bidx))
            gp = power_spectrum_db(Genh[..., 0], cfg.n_fft)
            cp = power_spectrum_db(clean, cfg.n_fft)
            sds.append(float((gp - cp).abs().mean()))
            if bidx >= max_samples:
                break
        return float(np.mean(sds))

    def train(self, cfg, dloader, l1_init: float = 100.0, l1_dec_step: float = 1e-5,
              l1_dec_epoch: int = 100, log_freq: int = 50, va_dloader=None):
        """The AEWSEGAN loop (the JAX ``AEWSEGAN.train``): the G step, log points with
        the power loss of the batch (logged, not trained on), ``evaluate_sd`` on the
        validation set at each log point with the best G saved under 'AEWSEGAN-G-', and
        EOE saves of G."""
        from ..utils.logging import TrainLogger

        self.init_train()
        self.writer = TrainLogger(os.path.join(cfg.save_path, "train"),
                                  enabled=self._chief())
        self._log_freq = log_freq
        eoe_saver = Saver(cfg.save_path, max_ckpts=3, prefix="EOE_G-", async_write=True)
        best_saver = Saver(cfg.save_path, max_ckpts=3, prefix=f"{self.name}-G-",
                           async_write=True)
        best = [np.inf]

        def step(batches):
            if len(batches) > 1:
                return self.train_step_multi(*self._stack_group(batches),
                                             l1_w_s=[l1_init] * len(batches))[1:]
            b = batches[0]
            return self.train_step(b["clean"][..., None], b["noisy"][..., None],
                                   b.get("mask"), l1_init)

        def log(iteration, total, num_batches, metrics, Genh, batch, timer, va):
            loss = float(metrics["loss"])  # waits for the step
            gp = power_spectrum_db(Genh[..., 0], cfg.n_fft)
            cp = power_spectrum_db(batch["clean"], cfg.n_fft)
            pow_loss = float((gp - cp).abs().mean())
            print(f"Iter {iteration}/{total} ({num_batches} bpe) g_l2_loss:{loss:.4f}, "
                  f"pow_loss: {pow_loss:.4f}, btime: {timer.last:.4f} s, mbtime: "
                  f"{timer.mean:.4f} s", flush=True)
            self.writer.scalar("g_l2/l1_loss", loss, iteration)
            self.writer.scalar("G_pow_loss", pow_loss, iteration)
            self._log_skip_alphas(iteration)
            if va is not None:
                sd = self.evaluate_sd(cfg, va)
                self.writer.scalar("Genh_SD", sd, iteration)
                if sd < best[0]:
                    if self._chief():
                        best_saver.save("Generator", iteration, self.G, best_val=True,
                                        trained_steps=self.step)
                    best[0] = sd

        self._run_loop(cfg, dloader, step, log, (eoe_saver, None), va_dloader)
        best_saver.flush()
        self.writer.close()

    def save(self, g_saver: Saver, d_saver: Optional[Saver], step: int,
             best_val: bool = False):
        """G with its optimizer's state, named after `step`; by the chief alone."""
        if self._chief():
            g_saver.save("Generator", step, self.G, self.g_opt, best_val=best_val,
                         trained_steps=self.step)
