"""The benchmark's own tests: run on the CPU with
``python -m pytest benchmark/tests -q`` from the repository's root; the tests
marked ``cuda`` skip there and run on a card."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny():
    """``tiny(name, **traffic)``: the cell ``name`` at a size a CPU test holds,
    with every width of the configuration but the plans' count and, for the
    agent, its width (the conv stack needs rays unpooled at res 64).
    ``explorer-step``, the Explorer's env step alone, is not a cell of
    ``BENCHMARK.json`` (``PERF.md``): it is made from the ``explorer``
    configuration and ``deathmatch-step``'s traffic and limits."""
    from benchmark import common

    def make(name, **traffic):
        if name == 'explorer-step':
            c = common.cell('deathmatch-step')
            c.update(name=name, config=common.load_json(common.HERE / 'configs' / 'explorer.json'))
        else:
            c = common.cell(name)
        c['config'].update(plans=3)
        if c['traffic']['driver'] == 'train':
            c['config'].update(res=64, subsample=1, width=16)
            c['traffic'].update(n_envs=8, buffer=4, batch=16)
        else:
            c['config'].update(res=256)
            c['traffic'].update(agent_envs=8 * c['config']['n_agents'], kept_steps=3,
                                max_steps=1000)
        c['traffic'].update(traffic)
        return c
    return make


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided here, never
    when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
