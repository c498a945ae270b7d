"""Rollout ms a chunk (the layer ``demo/train.py::rollout``): CUDA events from
the train step's ``mark`` hook, before and after the rollout; the median
chunk of the window."""
import numpy as np


def read(rec):
    values = rec.get('rollout_ms')
    return float(np.median(values)) if values else None
