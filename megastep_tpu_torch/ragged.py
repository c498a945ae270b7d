"""Ragged arrays: variable-length per-env data in one packed buffer.

Counterpart of :mod:`megastep_tpu.ragged` (the reference's
``megastep/ragged.py`` and the C++ ``Ragged``, ``src/common.h:102-155``):
``vals`` packed contiguously, ``widths`` per subarray, derived
``starts``/``ends``/``inverse``, int/slice indexing.

The engine does not consume raggeds: :func:`megastep_tpu_torch.scene.scenery`
compiles geometry into padded tensors with width masks. Raggeds are useful
host-side (building scenes, analyzing results) and as a conversion point:
:meth:`RaggedNumpy.padded` produces the padded+mask layout the engine uses, and
:meth:`RaggedNumpy.torchify` moves one onto a device.
"""
import dataclasses

import numpy as np
import torch

from .arrdict import torchify

__all__ = ['Ragged', 'RaggedNumpy', 'RaggedTorch']


class RaggedNumpy:
    """A ragged array over numpy storage (reference ``ragged.py:7-43``).

    :var vals: (total, ...) packed values.
    :var widths: (n,) subarray lengths.
    :var starts/ends: (n,) subarray extents.
    :var inverse: (total,) owning-subarray index of each value row.
    """

    def __init__(self, vals, widths):
        self.vals = np.asarray(vals)
        self.widths = np.asarray(widths)
        assert self.widths.sum() == len(self.vals), \
            f'widths sum to {self.widths.sum()}, vals has {len(self.vals)} rows'
        self.ends = self.widths.cumsum()
        self.starts = self.ends - self.widths

        # inverse via scatter-ADD + cumsum, like the C++ (common.h:88-99):
        # empty subarrays stack their +1 on the next start, so ids stay aligned.
        indices = np.zeros(len(self.vals) + 1, dtype=int)
        np.add.at(indices, self.starts, 1)
        self.inverse = indices[:len(self.vals)].cumsum() - 1

    def __len__(self):
        return len(self.widths)

    def __getitem__(self, i):
        if isinstance(i, int):
            return self.vals[self.starts[i]:self.ends[i]]
        if isinstance(i, slice):
            assert i.step in (None, 1), 'Only unit-step slices are supported'
            start, stop, _ = i.indices(len(self))
            return RaggedNumpy(
                self.vals[self.starts[start]:self.ends[stop - 1]] if stop > start
                else self.vals[:0],
                self.widths[start:stop])
        raise TypeError(f'Cannot index a ragged with {type(i)}')

    def __repr__(self):
        return f'{type(self).__name__}({len(self)} subarrays, {len(self.vals)} rows)'

    __str__ = __repr__

    def torchify(self, device='cpu'):
        """A copy on ``device`` as a :class:`RaggedTorch` (the JAX package's
        ``jaxify``). Float64 narrows to float32 and int64 to int32, as there."""
        return Ragged(torchify(self.vals, device), torchify(self.widths, device))

    def numpyify(self):
        return self

    def padded(self, length=None, value=0):
        """The engine's layout: ``(vals_padded (n, length, ...), mask (n, length))``."""
        length = int(self.widths.max()) if length is None else length
        shape = (len(self), length) + self.vals.shape[1:]
        out = np.full(shape, value, dtype=self.vals.dtype)
        mask = np.zeros((len(self), length), dtype=bool)
        for i in range(len(self)):
            w = self.widths[i]
            out[i, :w] = self.vals[self.starts[i]:self.ends[i]]
            mask[i, :w] = True
        return out, mask


@dataclasses.dataclass(frozen=True)
class RaggedTorch:
    """A ragged array over tensors: packed ``vals`` and ``widths`` with the
    derived indices, for masked or gather-style access on the device."""
    vals: torch.Tensor
    widths: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    inverse: torch.Tensor

    def __len__(self):
        return self.widths.shape[0]

    def numpyify(self):
        return RaggedNumpy(self.vals.cpu().numpy(), self.widths.cpu().numpy())


def Ragged(vals, widths):
    """Factory dispatching on storage: numpy → :class:`RaggedNumpy`, a tensor →
    :class:`RaggedTorch` on its device (reference ``ragged.py:60-75``)."""
    if not torch.is_tensor(vals):
        return RaggedNumpy(vals, widths)
    widths = torch.as_tensor(widths, device=vals.device)
    ends = torch.cumsum(widths, 0, dtype=widths.dtype)
    starts = ends - widths
    # One mark at each start, as the JAX factory's add with mode='drop': a
    # trailing empty subarray starts at len(vals) and marks nothing.
    marks = torch.zeros(vals.shape[0], dtype=widths.dtype, device=vals.device)
    inside = starts < vals.shape[0]
    marks.index_add_(0, starts[inside], torch.ones_like(starts[inside]))
    inverse = torch.cumsum(marks, 0, dtype=widths.dtype) - 1
    return RaggedTorch(vals=vals, widths=widths, starts=starts, ends=ends,
                       inverse=inverse)
