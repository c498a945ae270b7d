"""The demo RL stack: PPO/V-trace optimization and the training driver.

Counterpart of :mod:`megastep_tpu.demo` (the reference ``megastep/demo/__init__.py``):
the RL math (:mod:`.learning`) and the rollout → minibatched PPO learner with the
clipped AMSGrad optimizer and the KL early stop (:mod:`.train`), whose
``train()`` writes the run directory (stats, logs, stored weights) and
full-carry checkpoints, and whose ``demo()`` rolls out a trained agent and
records a video of it.
"""
from . import learning
from .train import (as_chunk, demo, init_carry, learn, make_train_step, optimize,
                    optimizer, ppo_loss, rollout, train)

__all__ = ['learning', 'as_chunk', 'demo', 'init_carry', 'learn', 'make_train_step',
           'optimize', 'optimizer', 'ppo_loss', 'rollout', 'train']
