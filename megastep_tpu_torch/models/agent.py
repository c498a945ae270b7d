"""The demo policy/value agent.

Counterpart of :mod:`megastep_tpu.models.agent` (the reference
``megastep/demo/__init__.py:13-35``): space-driven intake → recurrent core →
output for the policy, and an independent intake → core → scalar head for the
value, with the recurrent state explicit (an arrdict threaded through calls).
"""
import contextlib

import torch
from torch import nn

from ..arrdict import arrdict
from . import heads
from .hybrid import HybridCore
from .lstm import LSTM
from .transformer import Transformer

#: The cores by name; each takes ``(width, generator=..., **config)``.
CORES = dict(lstm=LSTM, transformer=Transformer, granite_hybrid=HybridCore)


@contextlib.contextmanager
def f32_math(device):
    """On CUDA, runs the block's convolutions and matmuls in full f32, as the
    JAX reference does: PyTorch lets cuDNN convolutions use TF32 by default.
    Both flags are put back on exit; on other devices this does nothing."""
    if torch.device(device).type != 'cuda':
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _core(kind, width, generator, config=None):
    if kind not in CORES:
        raise ValueError(f'Unknown core {kind!r}')
    return CORES[kind](width, generator=generator, **(config or {}))


class Agent(nn.Module):
    """A recurrent policy/value agent over a world's obs/action spaces.

    :param obs_space: observation space (dict or Multi* space).
    :param action_space: action space.
    :param width: hidden width (reference default 256).
    :param core: 'lstm', 'transformer' or 'granite_hybrid'.
    :param generator: the ``torch.Generator`` the fresh parameters are drawn
        from (flax's distributions, :mod:`.init`); the module is built on the
        CPU, and ``.to(device)`` moves it.

    Flax names the JAX agent's two cores by call order, ``LSTM_0`` (policy) and
    ``LSTM_1`` (value); here they are ``policy_core`` and ``value_core``.
    """

    def __init__(self, obs_space, action_space, width=256, core='lstm', generator=None,
                 core_config=None):
        super().__init__()
        self.width, self.core = width, core
        self.policy_intake = heads.intake(obs_space, width, generator)
        self.policy_core = _core(core, width, generator, core_config)
        self.policy_out = heads.output(action_space, width, generator)
        self.value_intake = heads.intake(obs_space, width, generator)
        self.value_core = _core(core, width, generator, core_config)
        self.value_out = heads.ValueOutput(width, generator)

    @property
    def device(self):
        return self.value_out.Dense_0.weight.device

    def initial_state(self, batch):
        """Zeroed recurrent state for both the policy and value cores, on the
        agent's device."""
        return arrdict(policy=self.policy_core.initial_state(batch, self.device),
                       value=self.value_core.initial_state(batch, self.device))

    def forward(self, world, state, generator=None, sample=False, value=False, test=False):
        """Runs the agent over a (T, B, ...) world chunk.

        :param world: arrdict with ``obs`` and ``reset`` (T, B) leaves.
        :param state: recurrent state from :meth:`initial_state` or a previous call.
        :param generator: the ``torch.Generator`` actions are drawn from when
            ``sample`` and not ``test``.
        :return: ``(decision, new_state)`` — decision holds ``logits`` and optionally
            ``actions``/``value``.
        """
        with f32_math(self.device):
            px = self.policy_intake(world.obs)
            py, pstate = self.policy_core(px, world.reset, state.policy)
            logits = self.policy_out(py)

            decision = arrdict(logits=logits)
            if sample or test:
                decision['actions'] = self.policy_out.sample(logits, generator, test)

            new_state = arrdict(policy=pstate, value=state.value)
            if value:
                vx = self.value_intake(world.obs)
                vy, vstate = self.value_core(vx, world.reset, state.value)
                decision['value'] = self.value_out(vy)
                new_state = arrdict(policy=pstate, value=vstate)
        return decision, new_state
