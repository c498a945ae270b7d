"""The hybrid train cell (``explorer-train-granite-h``): its frozen counts
against a hand-worked layer and the FLOP counter, its check at a small size
(the sound program passes, a scan that drops its resets does not), and its
per-layer readers."""
import math

import pytest
import torch

from benchmark import common
from benchmark.counts import hybrid, work
from benchmark.drivers import train_hybrid

#: A small core: Mamba-2 mixers of 4 heads of 8 at d 16, state 8; GQA of 2
#: heads over 1; MLP 32; an 8-slot memory.
SMALL = dict(hidden_size=16, mamba_n_heads=4, mamba_d_head=8, mamba_d_state=8,
             num_attention_heads=2, num_key_value_heads=1, shared_intermediate_size=32,
             mem_len=8, layer_types=['mamba', 'attention', 'mamba'])


def _small_cell(**traffic):
    c = common.cell('explorer-train-granite-h')
    c['config'].update(plans=3, res=64, subsample=1, **SMALL)
    c['traffic'].update(n_envs=8, buffer=8, batch=32, later_chunks=100, **traffic)
    return c


@pytest.fixture
def one_thread():
    """The ``train_hybrid`` driver's runs at this size on one thread: they
    take the CPU for tens of seconds, beside other files' timed windows."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _correct(c, numbers):
    return all(math.isfinite(v) and v <= c['limits'][k] for k, v in numbers)


def test_the_counts_of_a_hand_worked_mixer():
    """d 8, 2 heads of 8 (inner 16), state 4, conv 4: in_proj 8 → 16 + 24 + 2,
    the conv over 24 channels, out_proj 16 → 8."""
    cfg = dict(hidden_size=8, mamba_n_heads=2, mamba_d_head=8, mamba_d_state=4, mamba_d_conv=4,
               mamba_n_groups=1, mamba_conv_bias=True, mamba_proj_bias=False)
    assert hybrid.mamba_params(cfg) == 8 * 42 + 24 * 4 + 24 + 3 * 2 + 16 + 16 * 8 == 606
    assert hybrid.mamba_flops(cfg) == 2 * 8 * 42 + 2 * 4 * 24 + 5 * 2 * 8 * 4 + 2 * 16 * 8
    assert hybrid.state_bytes(cfg, 3) == 2 * 3 * (2 * 8 * 4 + 3 * 24) * 4 == 3264
    nbytes, flops = hybrid.mamba_step(cfg, 3)
    assert nbytes == 606 * 4 + 3264 + 2 * 3 * 8 * 4
    assert flops == 3 * 1440
    assert hybrid.mamba_roofline_ms(cfg, 3, 10) == 10 * work.roofline_ms(nbytes, flops)


def test_the_agent_count_against_the_flop_counter():
    """The frozen count of the agent's one-step forward against
    ``torch.utils.flop_counter``, which counts the matrix products alone: the
    count less the scan's elementwise terms (the conv, the state's decay and
    update) and with one more key a query (the counter sees the step's own key
    beside the memory's ``mem_len``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from megastep_tpu_torch import spaces
    from megastep_tpu_torch.dotdict import dotdict
    from megastep_tpu_torch.models import Agent
    cfg = dict(common.cell('explorer-train-granite-h')['config'], **SMALL)
    obs = dict(rgb=(1, 3, 1, 64), d=(1, 1, 1, 64), imu=(1, 3))
    space = dotdict(rgb=spaces.MultiImage(*obs['rgb']), d=spaces.MultiImage(*obs['d']),
                    imu=spaces.MultiVector(*obs['imu']))
    agent = Agent(space, spaces.MultiDiscrete(1, 7), width=16, core='granite_hybrid',
                  core_config=train_hybrid.core_config(cfg),
                  generator=torch.Generator().manual_seed(0))
    B = 3
    world = dotdict(obs=dotdict({k: torch.rand((1, B) + v) for k, v in obs.items()}),
                    reset=torch.zeros((1, B), dtype=torch.bool))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        agent(world, agent.initial_state(B), value=True)
    forward, _ = hybrid.agent(obs, 7, cfg)
    H, P, N, K = 4, 8, 8, 4
    scan = 2 * K * (H * P + 2 * N) + 3 * H * P * N
    keys = 2 * 2 * 16
    assert counter.get_total_flops() == B * (forward - 2 * 2 * scan + 2 * keys)


def test_the_sound_program_passes_the_check(one_thread):
    c = _small_cell()
    out = train_hybrid.run(c, 2**31 + 11, .3, 0, 'cpu', common.now())
    numbers = dict(out['checks'])
    assert _correct(c, out['checks']), numbers
    assert numbers['resets_missing'] == 0
    for tag in train_hybrid.TAGS:
        assert numbers[f'memory_mismatch{tag}'] == 0
        for k in ('logits_gap', 'value_gap', 'state_gap', 'loss_gap', 'grad_gap'):
            assert numbers[f'{k}{tag}'] < 1e-4, (k, tag)


def test_a_scan_that_drops_its_resets_fails_the_check(one_thread):
    c = _small_cell()
    out = train_hybrid.run(c, 2**31 + 11, .3, 0, 'cpu', common.now(), 'reset')
    numbers = dict(out['checks'])
    assert numbers['resets_missing'] == 0
    assert not _correct(c, out['checks']), numbers
    from megastep_tpu_torch.models import hybrid as program
    assert program.ssm_step.__name__ == 'ssm_step'  # the fault is taken out again


@pytest.mark.parametrize('name', ['mamba_ms.hybrid', 'mamba_roofline.hybrid', 'mfu.hybrid',
                                  'learn_graph_replays.hybrid'])
def test_a_reader_finds_nothing_in_an_other_cells_records(name):
    """The readers return nothing, and raise nothing, on records without
    what they read: the flagship train cell's, or a run that was not traced."""
    reader = common.reader(name)
    assert reader.read({}) is None
    assert reader.read(dict(window_s=51., chunks=20, samples_per_chunk=8, minibatches=[1.],
                            batch=8, obs_shapes={}, n_actions=7, width=256)) is None


def test_the_readers_on_a_traced_run():
    cfg = dict(common.cell('explorer-train-granite-h')['config'])
    core = dict(train_hybrid.core_config(cfg), hidden_size=cfg['hidden_size'])
    obs = dict(rgb=(1, 3, 1, 64), d=(1, 1, 1, 64), imu=(1, 3))
    rec = dict(window_s=50., chunks=10, samples_per_chunk=256 * 32, n_envs=256, batch=1024,
               minibatches=[8.] * 10, obs_shapes=obs, n_actions=7, hybrid=core,
               spans={'core.mamba': dict(n=32 * 18, device_ms=500.)},
               span_counts=dict(learn_graph_replays=8), span_minibatches=8.)
    read = lambda name: common.reader(name).read(rec)
    assert read('mamba_ms.hybrid') == 500.
    bound = hybrid.mamba_roofline_ms(core, 256, 32 * 18)
    assert read('mamba_roofline.hybrid') == pytest.approx(100 * bound / 500.)
    # Each of the 576 calls moves 2 × 256 × (64·64·128 + 3·4352) floats of state.
    assert hybrid.state_bytes(core, 256) == 2 * 256 * (64 * 64 * 128 + 3 * 4352) * 4
    forward, first = hybrid.agent(obs, 7, core)
    flops = 10 * 256 * 32 * forward + 80 * 1024 * work.train_sample(forward, first)
    assert read('mfu.hybrid') == pytest.approx(100 * flops / (50. * common.F32_FLOPS))
    assert read('learn_graph_replays.hybrid') == 1.
    # A chunk the KL stop cut to two minibatches still reads the graph path.
    rec.update(span_counts=dict(learn_graph_replays=2), span_minibatches=2.)
    assert read('learn_graph_replays.hybrid') == 1.
    rec['span_counts'] = {}
    assert read('learn_graph_replays.hybrid') == 0.


@pytest.mark.cuda
def test_a_short_traced_run_on_the_card_is_correct(card):
    """The ``train_hybrid`` driver at the small size on a card, traced:
    correct, the graph replayed once a minibatch, every reader a number."""
    c = _small_cell()
    out = train_hybrid.run(c, 2**31 + 3, 1., 1, 'cuda', common.now())
    assert _correct(c, out['checks']), out['checks']
    rec = out['records']
    assert rec['setup_counts']['learn_graph_captures'] == 1
    assert rec['span_counts']['learn_graph_replays'] == rec['span_minibatches']
    for m in c['per_layer']:
        assert common.reader(m['name']).read(rec) is not None, m['name']
