"""Device vitals: CUDA memory into the metric streams.

Counterpart of :mod:`megastep_tpu.rebar.stats.device` (which reads JAX's
``Device.memory_stats``): the memory the caching allocator has handed out,
``torch.cuda.memory_allocated``, as a share of the device's total memory. With
no CUDA device nothing is recorded, as the JAX module records nothing for a
device without memory stats.
"""
import time

import torch

from . import writing

_last = -1


def _share(i, used):
    return used / torch.cuda.get_device_properties(i).total_memory


def memory(device=0):
    """Records the current and peak allocated share of one device's memory
    (counterpart of ``gpu.py:9-15``)."""
    if not torch.cuda.is_available():
        return
    writing.max(f'device-memory/alloc/{device}',
                _share(device, torch.cuda.memory_allocated(device)))
    writing.max(f'device-memory/peak/{device}',
                _share(device, torch.cuda.max_memory_allocated(device)))


def vitals(device=None, throttle=0):
    """Records ``device/memory/{i}``, the percentage of device ``i``'s memory
    allocated, for one device or all, at most once per ``throttle`` seconds
    (counterpart of ``gpu.py:35-52``)."""
    global _last
    if time.time() - _last < throttle:
        return
    _last = time.time()
    if not torch.cuda.is_available():
        return
    indices = range(torch.cuda.device_count()) if device is None else [device]
    for i in indices:
        writing.mean(f'device/memory/{i}', 100 * _share(i, torch.cuda.memory_allocated(i)))
