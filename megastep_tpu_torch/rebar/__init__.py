"""rebar: the experiment-support library (counterpart of :mod:`megastep_tpu.rebar`).

Only :mod:`.fsm`, the tabular testbeds that validate the training stack, is
ported so far; stats, logging, storing, widgets and interrupting come with the
rebar slice.
"""
from . import fsm

__all__ = ['fsm']
