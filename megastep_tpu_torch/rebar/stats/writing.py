"""Stat writers, with deferred device-tensor batching.

Counterpart of :mod:`megastep_tpu.rebar.stats.writing`. Inside a ``defer()``
block, recorded tensors are only *queued*; at block exit they are
concatenated per (device, dtype) and fetched with **one** host copy each,
instead of one sync per metric (reference ``writing.py:56-125``).

Writer functions are generated per category: ``mean('loss', x)``,
``rate('sample-rate', n)``, etc.
"""
from contextlib import contextmanager
from functools import partial

import numpy as np
import torch

from .. import numpy as rnumpy
from . import categories

__all__ = ['to_dir', 'defer', 'record']

WRITER = None


@contextmanager
def to_dir(run_name):
    global WRITER
    old = WRITER
    WRITER = rnumpy.Writer(run_name, 'stats')
    try:
        yield
    finally:
        WRITER.close()
        WRITER = old


def clean(x):
    """A host value for a stat: a 0-d tensor or array becomes a Python scalar,
    a larger tensor a numpy array; dicts are cleaned leafwise."""
    if isinstance(x, torch.Tensor):
        x = x.item() if x.ndim == 0 else x.detach().cpu().numpy()
    if isinstance(x, np.ndarray) and x.ndim == 0:
        x = x.item()
    if isinstance(x, dict):
        return {k: clean(v) for k, v in x.items()}
    return x


def _write(category, field, args, kwargs):
    row = categories.CATEGORIES[category].row(*args, **kwargs)
    row = {'_time': np.datetime64('now'), **row}
    WRITER.write(f'{category}/{field}', row)


def eager_record(category, field, *args, **kwargs):
    if WRITER is None:
        return
    if not isinstance(field, str):
        raise ValueError(f'Field should be a string, is actually {field}')
    args = tuple(clean(a) for a in args)
    kwargs = {k: clean(v) for k, v in kwargs.items()}
    _write(category, field, args, kwargs)


_record = eager_record
QUEUE = None


def record(*args, **kwargs):
    return _record(*args, **kwargs)


def deferred_record(category, field, *args, **kwargs):
    if not isinstance(field, str):
        raise ValueError(f'Field should be a string, is actually {field}')
    QUEUE.append((category, field, args, kwargs))


def _rebuild(x, f):
    """``x`` with every tensor leaf replaced by ``f(leaf)``, walking tuples,
    lists and dicts (the queue's args, kwargs and nested dicts)."""
    if isinstance(x, torch.Tensor):
        return f(x)
    if isinstance(x, dict):
        return {k: _rebuild(v, f) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, f) for v in x)
    return x


def _to_host(flat):
    """The one device-to-host copy of a (device, dtype) group."""
    return flat.cpu()


def _flush(queue):
    """Replaces every queued tensor with its host value, using ONE host copy
    per (device, dtype): the tensors are flattened, concatenated, fetched once
    and split back by running offset."""
    groups = {}
    _rebuild(queue, lambda t: groups.setdefault((t.device, t.dtype), []).append(t))
    host = {}
    for key, ts in groups.items():
        flat = _to_host(torch.cat([t.detach().reshape(-1) for t in ts]))
        offset = 0
        for t in ts:
            host[id(t)] = flat[offset:offset + t.numel()].reshape(t.shape)
            offset += t.numel()
    return _rebuild(queue, lambda t: host[id(t)])


@contextmanager
def defer():
    """Queues all records inside the block; flushes with one host copy per
    (device, dtype) at exit (through the eager writer, which cleans the host
    values)."""
    global _record, QUEUE
    _record = deferred_record
    QUEUE = []
    try:
        yield
    finally:
        flushed, QUEUE = _flush(QUEUE), None
        _record = eager_record
        for category, field, args, kwargs in flushed:
            eager_record(category, field, *args, **kwargs)


for _c in categories.CATEGORIES:
    globals()[_c] = partial(record, _c)
    __all__.append(_c)
