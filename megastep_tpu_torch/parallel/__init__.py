"""The multi-device layer (counterpart of :mod:`megastep_tpu.parallel`).

Ported so far: :mod:`.checkpoint`, full-carry training checkpoints. The
env-axis data parallelism, per-rank scenery builds and the scaling harness come
with the parallel slice.
"""
from . import checkpoint

__all__ = ['checkpoint']
