"""Network components for the demo RL stack.

Counterpart of :mod:`megastep_tpu.models`, on ``torch.nn``: space-driven
intake/output head factories, a reset-aware LSTM, a Transformer-XL-style memory
core with GTrXL gating, a Granite-4.0-H hybrid core (Mamba-2 mixers and
memory attention), and the policy/value :class:`Agent`. All recurrent state
is explicit (passed in and returned), and fresh parameters take flax's
distributions (:mod:`.init`).
"""
from . import heads, hybrid, init, lstm, transformer
from .agent import Agent

__all__ = ['heads', 'hybrid', 'init', 'lstm', 'transformer', 'Agent']
