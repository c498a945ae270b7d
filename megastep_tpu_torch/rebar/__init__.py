"""rebar: the experiment-support library (counterpart of :mod:`megastep_tpu.rebar`).

Ported so far: :mod:`.fsm`, the tabular testbeds that validate the training
stack, and :mod:`.parallel`, the pools the cubicasa conversion fans out over;
stats, logging, storing, widgets and interrupting come with the rebar slice.
"""
from . import fsm, parallel

__all__ = ['fsm', 'parallel']
