"""State carried across from the JAX package, through numpy.

The engine runs no model, so its "weights" are the compiled scenery and the env
state. These helpers turn the JAX package's ``Scenery`` fields and env state,
given as numpy arrays (``np.asarray`` of each JAX array, done by the caller), into
the port's tensors. This module never sees a JAX array.
"""
import numpy as np
import torch

from .arrdict import arrdict
from .scene import Scenery, resolve_device

SCENERY_FIELDS = ('lines', 'lines_width', 'lights', 'lights_width', 'textures',
                  'tex_width', 'baked', 'line_tex_starts', 'line_tex_widths',
                  'tex_line', 'model')


def _tensor(x, device):
    return torch.tensor(np.asarray(x), device=device)


def scenery_from_numpy(fields, n_agents, n_dynamic_texels, device='cuda'):
    """A :class:`~megastep_tpu_torch.scene.Scenery` from a dict of numpy arrays,
    one per field of the JAX ``Scenery`` (same names, shapes and dtypes).

    :param n_agents, n_dynamic_texels: the JAX ``Scenery``'s static fields.
    """
    device = resolve_device(device)
    missing = set(SCENERY_FIELDS) - set(fields)
    if missing:
        raise KeyError(f'scenery fields missing: {sorted(missing)}')
    return Scenery(**{k: _tensor(fields[k], device) for k in SCENERY_FIELDS},
                   n_agents=int(n_agents), n_dynamic_texels=int(n_dynamic_texels))


def state_from_numpy(state, device='cuda'):
    """An env state arrdict from a nested dict of numpy arrays with the layout of
    the JAX env's state: Explorer's (``agents``, ``progress``, ``seen``,
    ``potential``, ``lengths``) or Deathmatch's (``agents``, ``progress``,
    ``health``, ``damage``, ``matchings``), each leaf keeping its dtype."""
    device = resolve_device(device)

    def convert(x):
        if isinstance(x, dict):
            return arrdict({k: convert(v) for k, v in x.items()})
        return _tensor(x, device)

    return convert(state)
