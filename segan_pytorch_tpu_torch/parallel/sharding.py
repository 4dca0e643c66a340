"""Collectives of a multi-GPU step and the split of D's head: the counterpart of
``segan_pytorch_tpu/parallel/sharding.py``.

Under jit the JAX package gets its collectives from XLA: a batch sharded over 'data'
makes every mean over it global and every gradient a psum, and the D-head leaves that
``_tp_spec`` places on 'model' are split Megatron-style. The port writes them out.
``Axis`` is one axis of the grid as a module holds it. Over the data axis:
``all_reduce`` (autograd's: its backward sums the gradient too, so a global statistic
takes every rank's rows back), ``reduce_gradients`` (one coalesced sum of a module's
gradients before its optimizer steps) and ``gather_cat`` (rows that cross ranks; over
the model axis the parts of a split vector). Over the model axis: ``to_model`` /
``from_model`` around a column-parallel and a row-parallel Linear, and ``shard_head`` /
``gather_head``, which split D's head and its optimizer moments and put them back
together.

Every gather is a sum of zero-filled slots (one all-reduce): gloo reduces CUDA tensors
but gathers only host ones, and two processes that share one card talk gloo.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterable, Optional

import torch
import torch.distributed as dist


class Axis:
    """One axis of the grid: its process group, its size and this rank's index on it.
    A copy of a module keeps the handle (a process group cannot be copied)."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, int(size), int(index)

    def __deepcopy__(self, memo):
        return self

    def part(self, n: int) -> slice:
        """This rank's part of a dimension of `n`, split evenly over the axis."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: `t` summed over the group."""
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """Sum over the group forward and backward: every rank's input feeds every rank's
    output, so each rank's gradient is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def all_reduce(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of `t` over the axis, differentiable: the backward sums the gradient over
    the axis too. `t` itself with no axis."""
    if axis is None:
        return t
    return _AllReduce.apply(t, axis.group)


def sum_values(values: Iterable[torch.Tensor], axis: Optional[Axis]):
    """Each 0-d tensor of `values` summed over the axis, in one all-reduce, without
    gradient: the losses of a step, which each rank holds for its rows."""
    values = list(values)
    if axis is None:
        return values
    dtype = functools.reduce(torch.promote_types, [v.dtype for v in values])
    flat = torch.stack([v.detach().to(dtype) for v in values])
    dist.all_reduce(flat, group=axis.group)
    return list(flat.unbind())


def reduce_gradients(params: Iterable[torch.nn.Parameter], axis: Optional[Axis]):
    """Sum the gradients of `params` over the axis in place, one all-reduce per dtype
    (the JAX psum of the gradients). Every rank holds gradients for the same parameters."""
    if axis is None:
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=axis.group)
        for g, r in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(r.view_as(g))


def gather_cat(t: torch.Tensor, axis: Optional[Axis], dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (of one shape), concatenated along `dim` in axis order, without
    gradient."""
    if axis is None:
        return t
    t = t.detach()
    slots = t.new_zeros((axis.size,) + tuple(t.shape))
    slots[axis.index] = t
    dist.all_reduce(slots, group=axis.group)
    return torch.cat(list(slots.unbind(0)), dim=dim)


class _ToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model axis (each rank
    holds the part that its columns of the split layer give)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _FromModel(torch.autograd.Function):
    """Sum over the model axis forward; identity backward (the sum is held whole by
    every rank, and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The input of a column-parallel layer, whole on every rank of the model axis."""
    return _ToModel.apply(x, axis.group)


def from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of a row-parallel layer's partial outputs over the model axis."""
    return _FromModel.apply(x, axis.group)


def _tp_spec(name: str, shape) -> Optional[int]:
    """The dimension of D's parameter `name` split over the model axis (the JAX
    ``_tp_spec``, ``:28-49``, in the torch names): the 'none' head's fc.0 column-parallel
    (its weight rows, its bias) with the fc.1 PReLU slope, fc.2 row-parallel (its weight
    columns); under spectral norm the weight is 'weight_orig' and u, v stay whole. None:
    replicated."""
    ndim = len(shape)
    if name in ("fc.0.weight", "fc.0.weight_orig") and ndim == 2:
        return 0
    if name in ("fc.0.bias", "fc.1.weight") and ndim == 1:
        return 0
    if name in ("fc.2.weight", "fc.2.weight_orig") and ndim == 2:
        return 1
    return None


def head_split(D: torch.nn.Module):
    """[(name, parameter, dim)] of D's parameters that the model axis splits."""
    out = []
    for name, p in D.named_parameters():
        dim = _tp_spec(name, p.shape)
        if dim is not None:
            out.append((name, p, dim))
    return out


def _set_axis(D: torch.nn.Module, axis: Optional[Axis]):
    """Give the 'none' head's split Linears their axis (None: whole again)."""
    if getattr(D, "pool_type", None) == "none":
        D.fc[0].tp = (axis, 0) if axis is not None else None
        D.fc[2].tp = (axis, 1) if axis is not None else None


def shard_head(D: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
               axis: Optional[Axis]):
    """Keep this rank's part of D's split head (``_tp_spec``) and of the optimizer's
    moments of those parameters, in place: the parameters stay the optimizer's. Raises
    ValueError when a split dimension does not divide by the axis size (JAX
    ``shard_params``, ``:101-105``)."""
    if axis is None or axis.size <= 1:
        return
    split = head_split(D)
    for name, p, dim in split:
        if p.shape[dim] % axis.size:
            raise ValueError(f"D-head dim {p.shape[dim]} at {name} not divisible by "
                             f"mp={axis.size}")
    for name, p, dim in split:
        full = tuple(p.shape)
        part = axis.part(full[dim])
        p.data = p.data.narrow(dim, part.start, part.stop - part.start).contiguous()
        state = optimizer.state.get(p, {}) if optimizer is not None else {}
        for k, v in state.items():
            if torch.is_tensor(v) and tuple(v.shape) == full:
                state[k] = v.narrow(dim, part.start, part.stop - part.start).contiguous()
    _set_axis(D, axis)


def gather_head(D: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
                axis: Optional[Axis]):
    """Put D's split head, and its optimizer moments, back together on every rank of the
    model axis (a collective): the inverse of ``shard_head``."""
    if axis is None or axis.size <= 1:
        return
    for name, p, dim in head_split(D):
        local = tuple(p.shape)
        p.data = gather_cat(p.data, axis, dim)
        state = optimizer.state.get(p, {}) if optimizer is not None else {}
        for k, v in state.items():
            if torch.is_tensor(v) and tuple(v.shape) == local:
                state[k] = gather_cat(v, axis, dim)
    _set_axis(D, None)


@contextlib.contextmanager
def whole_head(D: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
               axis: Optional[Axis]):
    """D's head whole inside the block (to save, load or count it), split again after
    from whatever it then holds."""
    gather_head(D, optimizer, axis)
    try:
        yield
    finally:
        shard_head(D, optimizer, axis)
