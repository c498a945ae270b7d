"""Stored weights: throttled atomic ``torch.save`` files of state trees.

Counterpart of :mod:`megastep_tpu.rebar.storing`, which pickles its trees:
here each object is saved as its ``state_dict()`` (or as the tree given) of
CPU tensors with ``torch.save``, and read back with ``weights_only=True``, so
loading runs no pickled code. Writes are atomic (a temporary file, then a
rename) and throttled by the file's mtime. The whole training carry goes
through :mod:`megastep_tpu_torch.parallel.checkpoint` instead.
"""
import time

import numpy as np
import torch

from . import paths

SUFFIX = '.pt'


def to_cpu(x):
    """A tree of dicts, lists and tuples with every tensor (or numpy array)
    as a CPU tensor, the form ``torch.load(weights_only=True)`` reads back."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_cpu(v) for v in x)
    return x


def _extract(v):
    return to_cpu(v.state_dict() if hasattr(v, 'state_dict') else v)


def store_latest(run_name, objs, throttle=0):
    """Atomically saves ``{name: state}`` into the run's storing group, unless a
    file younger than ``throttle`` seconds exists. Returns whether it saved."""
    path = paths.path(run_name, 'storing').with_suffix(SUFFIX)
    if path.exists() and (time.time() - path.lstat().st_mtime) < throttle:
        return False

    state = {k: _extract(v) for k, v in objs.items()}
    tmp = path.with_suffix('.tmp')
    torch.save(state, tmp)
    tmp.replace(path)
    return True


def _files(run_name, procname=None):
    """The run's stored files (of one process name, if given), oldest first."""
    found = paths.glob(run_name, 'storing', pattern=f'*{SUFFIX}')
    return [p for p in found if procname is None or paths.parse(p).procname == procname]


def stored(run_name=-1):
    """All stored files of a run, as a pandas frame."""
    import pandas as pd
    return pd.DataFrame([{**paths.parse(p), 'path': p} for p in _files(run_name)])


def load(run_name=-1, procname='MainProcess'):
    """Loads the newest stored file of a run's process ``procname``, as nested
    dicts of CPU tensors."""
    found = _files(run_name, procname)
    if not found:
        raise FileNotFoundError(f'no stored weights of {procname} in run {run_name!r}')
    return torch.load(found[-1], map_location='cpu', weights_only=True)


def runs():
    return paths.runs()
