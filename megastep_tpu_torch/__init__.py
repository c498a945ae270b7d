"""megastep_tpu_torch: the megastep_tpu environment engine on PyTorch and CUDA.

A port of :mod:`megastep_tpu` (the JAX package, which stays the reference) to
torch tensors on an NVIDIA GPU. It keeps the JAX package's module and public
names, so each function has a counterpart of the same name: the host scene
compile and light bake, momentum physics, the 1-D raycast renderer, the
dynamic re-bake, the Minimal, Explorer and Deathmatch envs, the cubicasa
floorplan pipeline (with its polygon booleans, raggeds and process pools, numpy
and the standard library only), the training stack
(the LSTM and transformer agents, PPO/V-trace with clipped AMSGrad, and the FSM
testbeds), and the run directory ``train()`` writes (rebar's stats, logs and
stored weights, and full-carry checkpoints in :mod:`.parallel.checkpoint`). The fused observe, a Pallas kernel in the JAX package, is a
hand-written CUDA kernel here (``csrc/observe.cu``), and so is the roofline's
f32 probe (``csrc/vpu_probe.cu``, in :mod:`.perf.roofline`). Deathmatch's
per-frame re-bake, XLA ops in the JAX package, is a second kernel in
``csrc/observe.cu`` (:func:`.ops.fused.rebake`).

This package imports torch and numpy, never jax and nothing of
``megastep_tpu``. Entry points default to ``device='cuda'``; they run on the
CPU only when the caller passes ``device='cpu'``, and raise when no GPU is
present and no device was given.
"""
__version__ = '0.1.0'

import importlib

from . import constants, spaces, geometry, toys
from .dotdict import dotdict

__all__ = ['constants', 'spaces', 'geometry', 'toys', 'dotdict', 'arrdict',
           'core', 'scene', 'modules', 'ops', 'envs', 'floorplans', 'cubicasa',
           'polygons', 'ragged', 'interop', 'kernels', 'perf', 'models', 'demo',
           'rebar', 'parallel', 'tracing']

_LAZY = {'arrdict', 'core', 'scene', 'modules', 'ops', 'envs', 'floorplans',
         'cubicasa', 'polygons', 'ragged', 'interop', 'kernels', 'perf', 'models',
         'demo', 'rebar', 'parallel', 'tracing'}


def __getattr__(name):
    """Imports the torch-dependent subsystems on first access, keeping
    ``import megastep_tpu_torch`` light."""
    if name in _LAZY:
        return importlib.import_module(f'.{name}', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
