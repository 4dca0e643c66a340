"""Several train steps per call on a CUDA graph: the counterpart of the JAX package's
``prepare_multi_step`` / ``train_step_multi`` (``segan_pytorch_tpu/models/segan.py:648-713``),
which runs S whole steps as one ``lax.scan``: one compiled body, S trips.

Here the body is an engine's step (``SEGAN._body``, and WSEGAN's and AEWSEGAN's), captured
once into a ``torch.cuda.CUDAGraph`` and replayed once per sub-step:

- Its inputs are static buffers on the card: the batch (clean, noisy, mask and WSEGAN's
  additive mask), the step's draws (z, the phase shifts, WSEGAN's misalignment
  permutation and square waves) and the L1 weight as a 0-d tensor. Before each replay the
  sub-step's values are copied into them on the card's stream (the host draws from
  pinned memory, without waiting), so a call of S sub-steps never syncs the host.
- The draws stay outside the graph: the engine draws them from its streams eagerly, in
  the order and count that its single step draws them, so S graphed sub-steps equal S
  ``train_step`` calls.
- The first sub-step of a new graph runs eagerly on a side stream (the warm-up that
  capture needs for cuDNN's plans, cuFFT's, autograd's and the optimizers' state) and is
  a real step; the graph is captured at the second, so the first call equals S eager
  steps from the same state.
- The optimizers keep their step counts on the card (``capturable``, set by
  ``set_capturable``), and the kernel's weight cache records its pad into the graph
  (``ops/kernels/conv1d_prelu.py`` ``_padded_weights``).
- A replay writes parameters, buffers (BatchNorm's statistics, spectral norm's u and v)
  and the optimizers' state in place without moving their version counters, which the
  kernel's weight cache and autograd read; after a call the versions of all of them are
  bumped (``mark_written``), and each parameter's ``.grad`` is pointed back at the
  graph's gradient, so it holds the last sub-step's as after ``train_step``.
- The graph keeps the step's activations in a private pool for as long as it lives
  (``pool_bytes``); ``release`` frees it.
- Under a multi-GPU grid (``parallel/``) the body's collectives are recorded with it: the
  losses' count and sums, BatchNorm's global statistics forward and backward, the
  gradients' all-reduces and D's split head. Every rank captures them in the same order,
  and the warm-up sub-step, which reaches every group of the step, makes their NCCL
  communicators before capture. Only NCCL can be recorded (``prepare_multi_step``
  refuses another backend), and the capture's error mode is thread-local, so NCCL's
  watchdog thread may query its events meanwhile.
A capture or a replay that fails raises; nothing falls back to eager steps.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def set_capturable(opt: torch.optim.Optimizer, on: bool):
    """Switch ``opt`` to (or from) the step that a CUDA graph can record: its step counts
    as tensors on the parameters' device. Keeps ``foreach``; the port never uses
    ``fused`` (``models/segan.py`` ``build_optimizer``)."""
    for group in opt.param_groups:
        group["capturable"] = on
        for p in group["params"]:
            state = opt.state.get(p)
            if state and torch.is_tensor(state.get("step")):
                state["step"] = state["step"].to(p.device if on else "cpu", torch.float32)


def mark_written(tensors):
    """Bump the version counter of each tensor, as an in-place op would: what a graph's
    replay wrote is then seen as changed by the kernel's weight cache and by autograd."""
    for t in tensors:
        torch.autograd.graph.increment_version(t)


class StepGraph:
    """One engine's step on a CUDA graph (see the module docstring). ``run`` takes the
    sub-steps' inputs, L1 weights and draws, each a list of S, and returns the metrics
    (dict of (S,) tensors) and the last sub-step's Genh."""

    def __init__(self, engine):
        self.engine = engine
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.warm = False
        self.x: Dict[str, torch.Tensor] = {}
        self.draws: Dict[str, Optional[torch.Tensor]] = {}
        self.l1: Optional[torch.Tensor] = None
        self.out = None
        self.grads: List[Tuple[torch.nn.Parameter, torch.Tensor]] = []
        self.pool_bytes = 0

    def release(self):
        """Free the graph, its pool and the static buffers; the parameters' gradients go
        with them."""
        for p, _ in self.grads:
            p.grad = None
        self.graph, self.key, self.warm, self.out, self.grads = None, None, False, None, []
        self.x, self.draws, self.l1 = {}, {}, None

    def _allocate(self, x, draws, key):
        self.release()
        dev = self.engine.device
        self.x = {k: torch.empty_like(v, device=dev) for k, v in x.items()}
        self.draws = {k: (torch.empty_like(v, device=dev) if v is not None else None)
                      for k, v in draws.items()}
        self.l1 = torch.zeros((), device=dev)
        self.key = key

    def _load(self, x, l1: float, draws):
        for k, v in x.items():
            self.x[k].copy_(v, non_blocking=True)
        for k, v in draws.items():
            if v is not None:
                if v.device.type == "cpu":
                    v = v.pin_memory()
                self.draws[k].copy_(v, non_blocking=True)
        self.l1.fill_(float(l1))

    def _warm_up(self):
        cur = torch.cuda.current_stream(self.engine.device)
        side = torch.cuda.Stream(self.engine.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.engine._body(self.x, self.l1, self.draws)
        cur.wait_stream(side)
        self.warm = True
        return out

    def _capture(self):
        dev = self.engine.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.out = self.engine._body(self.x, self.l1, self.draws)
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(dev) - before
        self.grads = [(p, p.grad) for p in self.engine._parameters() if p.grad is not None]

    def run(self, xs: List[dict], l1s, draws: List[dict]):
        x0, d0 = xs[0], draws[0]
        key = (tuple((k, tuple(v.shape), v.dtype) for k, v in x0.items()),
               tuple((k, None if v is None else (tuple(v.shape), v.dtype))
                     for k, v in d0.items()))
        if key != self.key:
            self._allocate(x0, d0, key)
        rows, replayed, any_replay = [], False, False
        for x, l1, d in zip(xs, l1s, draws):
            self._load(x, l1, d)
            if not self.warm:
                metrics, genh = self._warm_up()
                replayed = False
            else:
                if self.graph is None:
                    try:
                        self._capture()
                    except BaseException:
                        self.release()
                        raise
                self.graph.replay()
                metrics, genh = self.out
                replayed = any_replay = True
            rows.append(torch.stack(list(metrics.values())))
        if replayed:
            genh = genh.clone()
            for p, g in self.grads:
                p.grad = g
        if any_replay:
            eng = self.engine
            mark_written(list(eng._parameters()) + list(eng._buffers())
                         + [t for opt in eng._optimizers() for st in opt.state.values()
                            for t in st.values() if torch.is_tensor(t)])
        table = torch.stack(rows)
        return {k: table[:, j] for j, k in enumerate(metrics)}, genh
