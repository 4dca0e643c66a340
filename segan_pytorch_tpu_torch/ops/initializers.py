"""Weight initializers with the statistics of ``segan_pytorch_tpu/ops/initializers.py``,
on torch layouts and drawn from an explicit ``torch.Generator``.

The upstream SEGAN ``weights_init`` gives Conv1d weights N(0, 0.02) and zero bias; it
does not match ConvTranspose1d, which keeps torch's default kaiming-uniform init
(U(±1/sqrt(fan_in)), fan_in = Cout*K on the (Cin, Cout, K) weight). A seeded port
model has the JAX model's statistics, not its values: the two RNGs differ.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _uniform(shape: Sequence[int], bound: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(tuple(shape)).uniform_(-bound, bound, generator=generator)


def normal_002(shape: Sequence[int], generator: Optional[torch.Generator] = None):
    """N(0, 0.02): SEGAN conv weight init."""
    return torch.empty(tuple(shape)).normal_(0.0, 0.02, generator=generator)


def zeros(shape: Sequence[int], generator: Optional[torch.Generator] = None):
    return torch.zeros(tuple(shape))


def ones(shape: Sequence[int], generator: Optional[torch.Generator] = None):
    return torch.ones(tuple(shape))


def standard_normal(shape: Sequence[int], generator: Optional[torch.Generator] = None):
    return torch.empty(tuple(shape)).normal_(0.0, 1.0, generator=generator)


def xavier_uniform(shape: Sequence[int], generator: Optional[torch.Generator] = None):
    """torch ``nn.init.xavier_uniform_`` (gain 1) on a (out, in) Linear weight: U(±a),
    a = sqrt(6 / (in + out)). SEGAN's Linear weight init."""
    out_f, in_f = shape
    return _uniform(shape, math.sqrt(6.0 / (in_f + out_f)), generator)


def torch_default_convT_weight(shape: Sequence[int],
                               generator: Optional[torch.Generator] = None):
    """torch ConvTranspose1d default on a (Cin, Cout, K) weight: U(±1/sqrt(Cout*K))."""
    _, cout, k = shape
    return _uniform(shape, 1.0 / math.sqrt(cout * k), generator)


def torch_default_conv_weight(shape: Sequence[int],
                              generator: Optional[torch.Generator] = None):
    """torch Conv1d default (kaiming-uniform, a = sqrt(5)) on a (Cout, Cin, K) weight,
    or torch Linear's on an (out, in) one: U(±1/sqrt(fan_in)), fan_in = Cin*K or in."""
    fan_in = math.prod(shape[1:])
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)


def torch_default_bias(shape: Sequence[int], fan_in: int,
                       generator: Optional[torch.Generator] = None):
    """torch Conv/Linear default bias: U(±1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(shape, bound, generator)
