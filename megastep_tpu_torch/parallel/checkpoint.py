"""Full-carry training checkpoints.

Counterpart of :mod:`megastep_tpu.parallel.checkpoint` (orbax there): one
``torch.save`` file per step, ``<directory>/<step>.pt``, written atomically
(a temporary file, then a rename), of the whole training carry: the agent's
parameters, the optimizer's moments and count, the env state, the last world
and the recurrent state, each as nested dicts of CPU tensors. The newest
``max_to_keep`` steps are kept. A restore reads with ``weights_only=True``
and loads into a target carry of the same structure, on the target's devices.
"""
import re
from pathlib import Path

import torch

from ..arrdict import arrdict
from ..rebar.storing import to_cpu

_STEP = re.compile(r'^(\d+)\.pt$')


def _steps(directory):
    """The steps saved in ``directory``, ascending."""
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(m.group(1)) for m in map(_STEP.match, (p.name for p in d.iterdir())) if m)


def _state(v):
    return to_cpu(v.state_dict() if hasattr(v, 'state_dict') else v)


def save(directory, step, carry, max_to_keep=3):
    """Saves the full training carry at ``step`` and drops all but the newest
    ``max_to_keep`` steps. Returns the latest step."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f'.{step}.pt.tmp'
    torch.save({k: _state(v) for k, v in carry.items()}, tmp)
    tmp.replace(d / f'{step}.pt')
    for old in _steps(d)[:-max_to_keep]:
        (d / f'{old}.pt').unlink()
    return latest_step(d)


def _match(target, saved, where):
    """``saved`` in the structure of ``target``, each tensor on its target's
    device. Raises on a missing or extra key, or a tensor of another shape or
    dtype."""
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f'{where}: saved {type(saved).__name__}, not a tensor')
        if saved.shape != target.shape or saved.dtype != target.dtype:
            raise ValueError(f'{where}: saved {tuple(saved.shape)} {saved.dtype}, '
                             f'target {tuple(target.shape)} {target.dtype}')
        return saved.to(target.device)
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(f'{where}: saved keys {sorted(saved) if isinstance(saved, dict) else saved}'
                             f', target keys {sorted(target)}')
        return type(target)({k: _match(v, saved[k], f'{where}.{k}') for k, v in target.items()})
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise ValueError(f'{where}: saved {type(saved).__name__}, target '
                             f'{len(target)} entries')
        return type(target)(_match(v, s, f'{where}[{i}]')
                            for i, (v, s) in enumerate(zip(target, saved)))
    if type(saved) is not type(target):
        raise ValueError(f'{where}: saved {saved!r}, target {target!r}')
    return saved


def restore(directory, target, step=None):
    """Restores the checkpoint at ``step`` (default: the latest) into
    ``target``, a carry of the same structure: an object with
    ``load_state_dict`` (the agent, the optimizer) is loaded in place, and
    every other entry is rebuilt with its tensors on the target's devices.
    Returns the restored carry, or None when no checkpoint exists."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    saved = torch.load(Path(directory) / f'{step}.pt', map_location='cpu', weights_only=True)
    if set(saved) != set(target):
        raise ValueError(f'checkpoint holds {sorted(saved)}, target {sorted(target)}')
    out = arrdict()
    for k, v in target.items():
        if hasattr(v, 'load_state_dict'):
            v.load_state_dict(_match(v.state_dict(), saved[k], k))
            out[k] = v
        else:
            out[k] = _match(v, saved[k], k)
    return out


def latest_step(directory):
    """The newest saved step, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None
