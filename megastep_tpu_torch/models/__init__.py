"""Network components for the demo RL stack.

Counterpart of :mod:`megastep_tpu.models`, on ``torch.nn``: space-driven
intake/output head factories, a reset-aware LSTM, a Transformer-XL-style memory
core with GTrXL gating, and the policy/value :class:`Agent`. All recurrent state
is explicit (passed in and returned), and fresh parameters take flax's
distributions (:mod:`.init`).
"""
from . import heads, init, lstm, transformer
from .agent import Agent

__all__ = ['heads', 'init', 'lstm', 'transformer', 'Agent']
