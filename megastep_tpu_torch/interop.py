"""State carried across from the JAX package, through numpy.

The engine's "weights" are the compiled scenery and the env state, and the
training stack's are the agent's parameters. These helpers turn the JAX
package's ``Scenery`` fields, env state and flax ``Agent`` parameters, given as
numpy arrays (``np.asarray`` of each JAX array, done by the caller), into the
port's tensors. This module never sees a JAX array.
"""
from collections.abc import Mapping

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


#: flax names the agent's two cores by call order: the policy's first.
CORES = {'LSTM_0': 'policy_core', 'LSTM_1': 'value_core',
         'Transformer_0': 'policy_core', 'Transformer_1': 'value_core'}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def agent_params_from_numpy(params, agent):
    """Loads the JAX package's flax ``Agent`` parameters, a nested dict of numpy
    arrays, into the port's :class:`~megastep_tpu_torch.models.Agent` of the
    same spaces, width and core, in place. Returns the agent.

    The port's submodules keep flax's names, so each parameter maps by path:
    a Dense ``kernel`` (in, out) becomes ``weight`` transposed, a Conv
    ``kernel`` (1, k, C_in, C_out) a ``(C_out, C_in, 1, k)`` ``weight``, a
    LayerNorm ``scale`` its ``weight``; biases, ``k_bias``/``r_bias`` and the
    gates' ``b`` carry over as they are, and ``LSTM_0``/``LSTM_1`` (or
    ``Transformer_0``/``_1``) are the policy and value cores. Raises on a
    parameter with no place in the agent, a shape that differs, or a parameter
    of the agent left unloaded.
    """
    own = dict(agent.named_parameters())
    loaded = {}
    for path, value in _leaves(params):
        *mods, leaf = path
        value = np.asarray(value)
        if leaf == 'kernel':
            leaf = 'weight'
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        elif leaf == 'scale':
            leaf = 'weight'
        name = '.'.join([CORES.get(m, m) for m in mods] + [leaf])
        if name not in own:
            raise KeyError(f'{"/".join(path)} has no place in the agent (as {name})')
        if tuple(own[name].shape) != value.shape:
            raise ValueError(f'{"/".join(path)}: shape {value.shape} against the '
                             f"agent's {tuple(own[name].shape)}")
        loaded[name] = value
    missing = sorted(set(own) - set(loaded))
    if missing:
        raise KeyError(f'agent parameters not in the flax tree: {missing}')
    with torch.no_grad():
        for name, value in loaded.items():
            own[name].copy_(torch.from_numpy(np.array(value)))
    return agent
