"""The port's raggeds (``megastep_tpu_torch.ragged``) against the JAX package's,
on every case of ``tests/test_ragged.py`` and on a ragged that ends in empty
subarrays. Indices and values must be equal (tolerance: none).
"""
import numpy as np
import pytest
import torch

from megastep_tpu_torch.ragged import Ragged, RaggedNumpy, RaggedTorch

torch.set_num_threads(1)

#: (vals, widths) of tests/test_ragged.py's fixture, and one that ends in two
#: empty subarrays (their starts are len(vals), past the end).
CASES = {'fixture': (np.arange(10), np.array([3, 0, 4, 3])),
         'trailing_empty': (np.arange(10), np.array([3, 0, 4, 3, 0, 0])),
         'leading_empty': (np.arange(5), np.array([0, 0, 5]))}


@pytest.fixture(scope='module')
def jragged():
    return pytest.importorskip('megastep_tpu.ragged')


@pytest.mark.parametrize('case', sorted(CASES))
def test_derived_indices_match_jax(jragged, case):
    vals, widths = CASES[case]
    r, jr = Ragged(vals, widths), jragged.Ragged(vals, widths)
    assert isinstance(r, RaggedNumpy)
    for k in ('starts', 'ends', 'inverse'):
        np.testing.assert_array_equal(getattr(r, k), getattr(jr, k), err_msg=k)
    for i in range(len(r)):
        np.testing.assert_array_equal(r[i], jr[i])
    out, mask = r.padded()
    jout, jmask = jr.padded()
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(mask.sum(1), widths)


@pytest.mark.parametrize('case', sorted(CASES))
def test_torch_factory_matches_jax(jragged, case):
    """The tensor factory against the JAX one: a start at len(vals) marks
    nothing (JAX drops it; ``index_add_`` would raise on it)."""
    import jax.numpy as jnp
    vals, widths = CASES[case]
    t = Ragged(torch.from_numpy(vals), torch.from_numpy(widths))
    j = jragged.Ragged(jnp.asarray(vals), jnp.asarray(widths))
    assert isinstance(t, RaggedTorch) and len(t) == len(j) == len(widths)
    for k in ('vals', 'widths', 'starts', 'ends', 'inverse'):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(t.inverse.numpy(), RaggedNumpy(vals, widths).inverse)


def test_int_indexing():
    r = Ragged(*CASES['fixture'])
    np.testing.assert_array_equal(r[0], [0, 1, 2])
    np.testing.assert_array_equal(r[1], [])
    np.testing.assert_array_equal(r[2], [3, 4, 5, 6])


def test_slice_indexing_matches_jax(jragged):
    r, jr = Ragged(*CASES['trailing_empty']), jragged.Ragged(*CASES['trailing_empty'])
    for sl in (slice(1, 3), slice(3, 6), slice(4, 6), slice(2, 2)):
        s, js = r[sl], jr[sl]
        assert len(s) == len(js)
        np.testing.assert_array_equal(s.vals, js.vals)
        np.testing.assert_array_equal(s.widths, js.widths)
    np.testing.assert_array_equal(r[1:3][1], [3, 4, 5, 6])
    with pytest.raises(TypeError):
        r['a']


def test_width_mismatch():
    with pytest.raises(AssertionError):
        Ragged(np.arange(5), np.array([3, 3]))


def test_torchify_roundtrip(jragged):
    r = Ragged(*CASES['trailing_empty'])
    t = r.torchify('cpu')
    j = jragged.Ragged(*CASES['trailing_empty']).jaxify()
    # Narrowed to 32 bits, as jaxify narrows.
    assert t.vals.dtype == torch.int32 and str(j.vals.dtype) == 'int32'
    np.testing.assert_array_equal(t.inverse.numpy(), np.asarray(j.inverse))
    back = t.numpyify()
    np.testing.assert_array_equal(back.vals, r.vals)
    np.testing.assert_array_equal(back.widths, r.widths)
