"""rebar: the experiment-support library (counterpart of :mod:`megastep_tpu.rebar`).

The run directory (:mod:`.paths`, :mod:`.numpy`'s ``.npr`` streams,
:mod:`.stats`, :mod:`.logging`, :mod:`.storing`), :mod:`.widgets`,
:mod:`.interrupting` and :mod:`.contextlib`; :mod:`.fsm`, the tabular testbeds
that validate the training stack; :mod:`.parallel`, the pools the cubicasa
conversion and the video encoder fan out over; :mod:`.recording`, the video
encoder; :mod:`.plots`, the stats dashboards; :mod:`.queuing`, actor/learner
queues with a deadlock-free shutdown; and :mod:`.processes`, process groups
(``torch.distributed``), group-wide consensus and supervised children. Nothing here imports
matplotlib, Pillow, pandas, IPython or ipywidgets until a function that draws,
encodes, reads frames or shows a notebook pane is called.
"""
import importlib

from ..dotdict import dotdict

# The real arrdict *module* (the package root would otherwise give the class).
arrdict = importlib.import_module('megastep_tpu_torch.arrdict')

from . import (contextlib, paths, numpy, stats, storing, parallel, widgets,  # noqa: E402
               interrupting, logging, fsm, recording, plots, queuing, processes)

__all__ = ['dotdict', 'arrdict', 'paths', 'numpy', 'stats', 'storing', 'parallel',
           'widgets', 'interrupting', 'logging', 'fsm', 'contextlib', 'recording',
           'plots', 'queuing', 'processes']
