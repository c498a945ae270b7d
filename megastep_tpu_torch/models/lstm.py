"""A reset-aware LSTM core.

Counterpart of :mod:`megastep_tpu.models.lstm` (the reference
``megastep/demo/lstm.py:7-94``): a loop over time whose carried ``(h, c)`` is
zeroed wherever ``reset[t]`` is set, so the hidden state is exactly zero at the
start of every episode. ``torch.nn.LSTM`` (cuDNN) is not used: it cannot zero
its state at per-step resets without re-packing the batch, and its weight layout
is not the JAX one.

State is explicit: ``initial_state(batch)`` makes the (h, c) arrdict, ``forward``
takes and returns it.
"""
import torch
from torch import nn

from ..arrdict import arrdict
from .init import linear, orthogonal_blocks_


class LSTM(nn.Module):
    """A single-layer LSTM over (T, B, d_model) inputs with per-step reset masking.

    The input projection of all T steps is one (T·B, D) @ (D, 4H) product ahead
    of the loop; per step only the recurrent (B, H) @ (H, 4H) product remains.
    The gate math is the JAX package's (``lstm.py:64-78``): gates split in
    (i, f, g, o) order, the bias on the recurrent projection ``wh`` only, sums
    ordered h-part + x-part.

    :param d_model: input and hidden width.
    """

    def __init__(self, d_model, generator=None):
        super().__init__()
        self.d_model = d_model
        self.wi = linear(d_model, 4 * d_model, bias=False, generator=generator)
        self.wh = linear(d_model, 4 * d_model, generator=generator)
        orthogonal_blocks_(self.wh.weight, 4, generator)

    def initial_state(self, batch, device=None, dtype=torch.float32):
        return arrdict(
            h=torch.zeros((batch, self.d_model), dtype=dtype, device=device),
            c=torch.zeros((batch, self.d_model), dtype=dtype, device=device))

    def forward(self, x, reset, state):
        """:param x: (T, B, d_model) inputs.
        :param reset: (T, B) bool; True zeroes the carried state *before* consuming
            ``x[t]`` (an episode boundary between t-1 and t).
        :param state: (h, c) arrdict from :meth:`initial_state` or a previous call.
        :return: ``(y, new_state)`` with y (T, B, d_model); the new state is
            detached.
        """
        xw = self.wi(x)                                     # (T, B, 4H)
        c, h = state.c, state.h
        ys = []
        for t in range(x.shape[0]):
            keep = ~reset[t][:, None]
            c = torch.where(keep, c, 0.)
            h = torch.where(keep, h, 0.)
            z = self.wh(h) + xw[t]
            zi, zf, zg, zo = z.chunk(4, -1)
            i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
            g = torch.tanh(zg)
            c = f * c + i * g
            h = o * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys), arrdict(h=h.detach(), c=c.detach())
