"""The check that decides ``correct``: the plain reference agrees with the
port's CPU path at a small size, and the control (the reference in the next
lower precision, in the program's place) and each planted fault come out not
correct by the cell's own limits."""
import pytest

from benchmark import common, readings

STEP_CELLS = ('explorer-step', 'deathmatch-step')


def _correct(c, numbers):
    return all(v <= c['limits'][k] for k, v in numbers)


@pytest.mark.parametrize('name', STEP_CELLS + ('explorer-train',))
def test_the_reference_agrees_with_the_port_on_the_cpu(tiny, name):
    """A whole run of the cell's driver at a small size: every step kept, the
    reset, the scenery; for the train cell its checked chunks, each with two
    learner minibatches."""
    c = tiny(name)
    out = common.driver(c).run(c, 2**31 + 11, .5, 0, 'cpu', common.now())
    numbers = dict(out['checks'])
    assert _correct(c, out['checks']), numbers
    if name == 'explorer-train':
        assert numbers['rollout_mismatch'] == 0
        assert numbers['grad_gap'] < 1e-5 and numbers['loss_gap'] < 1e-5
    else:
        assert numbers == dict(scenery_gap=0., obs_mismatch=0, state_mismatch=0)


@pytest.mark.parametrize('name', STEP_CELLS)
def test_the_bfloat16_control_is_not_correct(tiny, name):
    c = tiny(name)
    numbers = readings.step_reading(c, 3, 'control', 6, 'cpu')
    assert not _correct(c, numbers), numbers


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'alter'])
@pytest.mark.parametrize('name', STEP_CELLS)
def test_a_faulty_step_is_not_correct(tiny, name, fault):
    c = tiny(name)
    out = common.driver(c).run(c, 5, .3, 0, 'cpu', common.now(), fault)
    assert not _correct(c, out['checks']), out['checks']


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'alter'])
def test_a_faulty_train_step_is_not_correct(tiny, fault):
    c = tiny('explorer-train')
    out = common.driver(c).run(c, 5, .1, 0, 'cpu', common.now(), fault)
    assert not _correct(c, out['checks']), out['checks']


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct_on_the_card(card, tiny):
    """TF32 changes nothing on the CPU, so this control runs on a card, at a
    size a test run holds."""
    c = tiny('explorer-train', n_envs=64, buffer=8, batch=256)
    c['config'].update(width=64)
    numbers = readings.train_reading(c, 3, 'control', 'cuda')
    assert not _correct(c, numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize('name', STEP_CELLS + ('explorer-train',))
def test_a_short_run_on_the_card_is_correct(card, tiny, name):
    c = tiny(name)
    out = common.driver(c).run(c, 2**31 + 3, 1., 1, 'cuda', common.now())
    assert _correct(c, out['checks']), out['checks']
    assert out['records']['trace']['device']['name'].size
