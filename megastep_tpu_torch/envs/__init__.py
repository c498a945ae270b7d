"""Demo environments built on the engine (counterpart of
:mod:`megastep_tpu.envs`).

Each env holds static config and device tables; ``reset(rng)`` and
``step(state, decision, rng)`` return ``(state, world)`` with ``world`` the
decision/world arrdict protocol: ``obs``, ``reward``, ``reset``. Explorer and
Deathmatch are ported; Minimal waits.
"""
from .deathmatch import Deathmatch
from .explorer import Explorer

__all__ = ['Deathmatch', 'Explorer']
