"""The multi-device layer (counterpart of :mod:`megastep_tpu.parallel`).

Env-axis data parallelism over ``torch.distributed`` ranks, one process a rank
(:mod:`.mesh`: the sharded train step and its collectives), per-rank env builds
(:mod:`.host`), the scaling harness (:mod:`.scaling`) and full-carry training
checkpoints (:mod:`.checkpoint`). The JAX package's ``env_sharding``,
``replicated`` and ``shard_carry`` place one global array over a device mesh;
the port has none, and :mod:`.mesh` says why for each.
"""
from .mesh import mesh, make_sharded_train_step
from . import checkpoint

__all__ = ['mesh', 'make_sharded_train_step', 'checkpoint']
