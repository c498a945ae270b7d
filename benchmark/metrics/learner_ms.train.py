"""Learner ms a chunk (the layer ``demo/train.py::learn`` with
``ClippedAMSGrad``): CUDA events from the train step's ``mark`` hook, after
the rollout and after the learner; the median chunk of the window."""
import numpy as np


def read(rec):
    values = rec.get('learner_ms')
    return float(np.median(values)) if values else None
