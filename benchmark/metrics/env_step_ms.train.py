"""Env-step ms a chunk inside the rollout (the layer
``envs/explorer.py::Explorer.step``): CUDA events around each ``env.step``,
recorded by the benchmark's proxy of the env, summed over a chunk; the median
chunk of the window."""
import numpy as np


def read(rec):
    values = rec.get('env_step_ms')
    return float(np.median(values)) if values else None
