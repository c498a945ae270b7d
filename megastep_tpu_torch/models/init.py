"""Parameter initialisers with flax's distributions.

The JAX package's modules take flax's defaults, and learning dynamics depend on
them, so the port draws its fresh parameters from the same distributions rather
than PyTorch's (kaiming-uniform weights, uniform biases): ``lecun_normal`` (a
normal truncated at two standard deviations, scaled by fan-in) for Dense and
Conv kernels, zero biases, and per-block orthogonal matrices for the LSTM's
recurrent kernel. Every draw takes an explicit ``torch.Generator`` (``None``
means PyTorch's global one).
"""
import math

import torch
from torch import nn

#: The standard deviation of a unit normal truncated to [-2, 2] (flax's
#: ``variance_scaling`` divides by it so the kernel's std is sqrt(1/fan_in)).
TRUNCATED_STD = .87962566103423978


@torch.no_grad()
def lecun_normal_(weight, fan_in, generator=None):
    """flax's ``lecun_normal``: truncated normal with std ``sqrt(1/fan_in)``."""
    nn.init.trunc_normal_(weight, 0., 1., -2., 2., generator=generator)
    return weight.mul_(math.sqrt(1 / fan_in) / TRUNCATED_STD)


@torch.no_grad()
def orthogonal_blocks_(weight, n_blocks, generator=None):
    """An independent orthogonal (H, H) matrix in each of ``n_blocks`` row
    blocks of an (n_blocks·H, H) weight: the LSTM's per-gate init."""
    for block in weight.chunk(n_blocks, 0):
        nn.init.orthogonal_(block, generator=generator)
    return weight


def linear(d_in, d_out, bias=True, generator=None):
    """A ``Linear`` initialised as flax's ``Dense``."""
    layer = nn.Linear(d_in, d_out, bias=bias)
    lecun_normal_(layer.weight, d_in, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def conv_1xk(c_in, c_out, k, stride, generator=None):
    """A ``(1, k)`` VALID ``Conv2d`` initialised as flax's ``Conv``."""
    layer = nn.Conv2d(c_in, c_out, (1, k), stride=(1, stride))
    lecun_normal_(layer.weight, c_in * k, generator)
    nn.init.zeros_(layer.bias)
    return layer
