"""The stats system: typed metric channels over append-only npr files.

Counterpart of :mod:`megastep_tpu.rebar.stats` — see :mod:`.categories` for
the category semantics, :mod:`.writing` for the deferred device-tensor
batching, and :mod:`.reading` for resampling and display. ``gpu`` is aliased to
:mod:`.device` (CUDA memory vitals). Writing needs no pandas.
"""
import time
from contextlib import contextmanager

from .writing import *           # noqa: F401,F403 — record + per-category writers
from .writing import to_dir, record, defer, mean
from .reading import from_dir, Reader, arrays, pandas, resample
from . import device
from . import device as gpu      # parity alias for the reference name

from .. import paths


@contextmanager
def via_dir(run_name, *args, **kwargs):
    """Write stats to a run dir and display them live (reference
    ``stats/__init__.py:18-21``)."""
    with to_dir(run_name), from_dir(run_name, *args, **kwargs):
        yield


def funcduty(name):
    """Decorator recording the wall-clock duty cycle of a method into
    ``duty/<name>`` (reference ``stats/__init__.py:44-52``)."""
    def factory(f):
        def g(self, *args, **kwargs):
            start = time.time()
            result = f(self, *args, **kwargs)
            record('duty', f'duty/{name}', time.time() - start)
            return result
        return g
    return factory


def compare(run_names=(-1,), prefix='', rule='60s'):
    """Cross-run comparison frame (reference ``stats/__init__.py:54-55``)."""
    import pandas as pd
    return pd.concat({paths.resolve(run): Reader(run, prefix).resample(rule)
                      for run in run_names}, axis=1)
