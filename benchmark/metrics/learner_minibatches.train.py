"""Minibatches the learner ran a chunk before the KL stop: the train step's
own ``minibatches`` output; the median chunk of the window. It tells less work
from more speed when ``learner_ms.train`` moves."""
import numpy as np


def read(rec):
    values = rec.get('minibatches')
    return float(np.median(values)) if values else None
