"""Space-driven network head factories.

Counterpart of :mod:`megastep_tpu.models.heads` (the reference
``megastep/demo/heads.py:9-126``): :func:`intake` maps an observation space to an
encoder module producing a ``width``-dim feature, and :func:`output` maps an
action space to a decoder head producing (log-)policies. Heads accept any
leading batch dims (T, B, ...) and work on the trailing space dims.

Submodules keep the names flax gives the JAX package's layers (``Dense_0``,
``Conv_1``, ...), so :func:`megastep_tpu_torch.interop.agent_params_from_numpy`
maps flax parameters onto them by path.
"""
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..dotdict import dotdict
from ..ops.geom import div
from .init import conv_1xk, linear

#: The 1-D conv stack of ``MultiImageIntake``: (channels, kernel, stride).
CONVS = ((32, 8, 4), (64, 4, 2), (128, 3, 2))


class MultiVectorIntake(nn.Module):
    """Encodes an (A, C) vector space: per-agent MLP, then a projection over the
    concatenated agents (reference ``heads.py:9-26``)."""

    def __init__(self, space, width, generator=None):
        super().__init__()
        A, C = space.shape
        self.Dense_0 = linear(C, width, generator=generator)
        self.Dense_1 = linear(A * width, width, generator=generator)

    def forward(self, obs):
        lead = obs.shape[:-2]
        x = F.relu(self.Dense_0(obs))
        return F.relu(self.Dense_1(x.reshape(*lead, -1)))


class MultiImageIntake(nn.Module):
    """Encodes an (A, C, H, W) image space with the reference's 1-D conv stack —
    kernels 8/4/3, strides 4/2/2 (``heads.py:28-54``) — then a two-layer
    projection.

    The JAX package runs NHWC convs and flattens each sample in (H, W, C) order;
    here the convs run NCHW and the output is made channels-last before the
    flatten, so the first Dense takes the JAX kernel as it is. The stack needs
    an image at least 36 pixels wide.
    """

    def __init__(self, space, width, generator=None):
        super().__init__()
        A, C, H, W = space.shape
        for i, (c_out, k, s) in enumerate(CONVS):
            self.add_module(f'Conv_{i}', conv_1xk(C, c_out, k, s, generator))
            C, W = c_out, (W - k) // s + 1
        if W < 1:
            raise ValueError(f"an image {space.shape[-1]} pixels wide is too "
                             'narrow for the conv stack (36 at least)')
        self.Dense_0 = linear(A * H * W * C, width, generator=generator)
        self.Dense_1 = linear(width, width, generator=generator)
        self.space_shape = space.shape

    def forward(self, obs):
        A, C, H, W = self.space_shape
        lead = obs.shape[:-4]
        if obs.dtype == torch.uint8:
            obs = div(obs.float(), 255.)
        x = obs.reshape(-1, C, H, W)
        for i in range(len(CONVS)):
            x = F.relu(getattr(self, f'Conv_{i}')(x))
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)
        x = F.relu(self.Dense_0(x))
        return F.relu(self.Dense_1(x))


class ConcatIntake(nn.Module):
    """Encodes a dict space by concatenating per-key intakes through a linear mix
    (reference ``heads.py:56-67``).

    The intakes are concatenated in sorted key order (Explorer: d, imu, rgb),
    not in the space's own: that is the order the JAX package's module sees,
    since flax freezes a dict attribute into a ``FrozenDict`` with sorted keys.
    """

    def __init__(self, space, width, generator=None):
        super().__init__()
        self.keys = sorted(space)
        for k in self.keys:
            self.add_module(k, intake(space[k], width, generator))
        self.Dense_0 = linear(len(space) * width, width, generator=generator)

    def forward(self, obs):
        ys = [getattr(self, k)(obs[k]) for k in self.keys]
        return self.Dense_0(torch.cat(ys, -1))


def intake(space, width, generator=None):
    """Space → encoder module (reference ``heads.py:69-75``)."""
    if isinstance(space, Mapping):
        return ConcatIntake(space, width, generator)
    cls = globals().get(f'{type(space).__name__}Intake')
    if cls is None:
        raise ValueError(f"Can't handle {space}")
    return cls(space, width, generator)


def categorical(logits, generator=None):
    """One draw from each categorical over the last axis of ``logits``, by the
    Gumbel-max trick (as ``jax.random.categorical`` draws), from ``generator``.

    :param generator: a ``torch.Generator``, or the uniform draws themselves,
        shaped like ``logits``. As in JAX, a draw is floored at the dtype's
        smallest normal number, so a 0 gives finite noise, not -inf.
    """
    if isinstance(generator, torch.Tensor):
        u = generator.to(logits.device, logits.dtype)
    else:
        u = torch.rand(logits.shape, generator=generator, device=logits.device,
                       dtype=logits.dtype)
    u = u.clamp(min=torch.finfo(logits.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), -1)


class MultiDiscreteOutput(nn.Module):
    """Decodes to per-agent categorical log-policies (reference ``heads.py:77-93``)."""

    def __init__(self, space, width, generator=None):
        super().__init__()
        self.shape = tuple(space.shape)
        self.Dense_0 = linear(width, int(np.prod(self.shape)), generator=generator)

    def forward(self, x):
        y = self.Dense_0(x).reshape(*x.shape[:-1], *self.shape)
        return F.log_softmax(y, -1)

    @staticmethod
    def sample(logits, generator=None, test=False):
        """Actions from ``logits``: a draw from ``generator``, or the argmax when
        ``test``."""
        if test:
            return torch.argmax(logits, -1)
        return categorical(logits, generator)


class DictOutput(nn.Module):
    """Decodes a dict space: a linear split into per-key features, one output head
    each (reference ``heads.py:95-108``). Submodules are named as flax names the
    JAX package's, ``core`` and ``outputs_<key>``, and split in sorted key
    order, as in :class:`ConcatIntake`."""

    def __init__(self, space, width, generator=None):
        super().__init__()
        self.keys = sorted(space)
        self.core = linear(width, width * len(space), generator=generator)
        for k in self.keys:
            self.add_module(f'outputs_{k}', output(space[k], width, generator))

    def forward(self, x):
        ys = torch.chunk(self.core(x), len(self.keys), -1)
        return dotdict({k: getattr(self, f'outputs_{k}')(y) for k, y in zip(self.keys, ys)})

    def sample(self, logits, generator=None, test=False):
        return dotdict({k: getattr(self, f'outputs_{k}').sample(logits[k], generator, test)
                        for k in self.keys})


class ValueOutput(nn.Module):
    """A scalar value head (reference ``heads.py:110-117``)."""

    def __init__(self, width, generator=None):
        super().__init__()
        self.Dense_0 = linear(width, 1, generator=generator)

    def forward(self, x):
        return self.Dense_0(x)[..., 0]


def output(space, width, generator=None):
    """Space → decoder module (reference ``heads.py:119-126``)."""
    if isinstance(space, Mapping):
        return DictOutput(space, width, generator)
    cls = globals().get(f'{type(space).__name__}Output')
    if cls is None:
        raise ValueError(f"Can't handle {space}")
    return cls(space, width, generator)
