"""The port's code constructions against the JAX package's: bit for bit."""
import numpy as np
import pytest

from repro.core import density_evolution as jde
from repro.core import ldpc as jldpc
from repro_torch.core import density_evolution as tde
from repro_torch.core import ldpc as tldpc

CASES = [(K, seed) for K in (20, 64, 128) for seed in (0, 1, 2)]


def _assert_same_code(a, b):
    for f in ("N", "K", "l", "r", "kind", "seed", "p"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("H", "G", "check_idx", "check_coeff", "var_idx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("K,seed", CASES)
def test_make_regular_ldpc_bit_identical(K, seed):
    _assert_same_code(jldpc.make_regular_ldpc(K, l=3, r=6, seed=seed),
                      tldpc.make_regular_ldpc(K, l=3, r=6, seed=seed))


@pytest.mark.parametrize("K,seed", CASES)
def test_make_parity_only_ldpc_bit_identical(K, seed):
    _assert_same_code(jldpc.make_parity_only_ldpc(K, l=3, r=6, seed=seed),
                      tldpc.make_parity_only_ldpc(K, l=3, r=6, seed=seed))


@pytest.mark.parametrize("values", ["gaussian", "pm1"])
def test_edge_weight_kinds_bit_identical(values):
    _assert_same_code(jldpc.make_regular_ldpc(20, seed=3, values=values),
                      tldpc.make_regular_ldpc(20, seed=3, values=values))


def test_code_is_systematic_and_encodes_codewords():
    code = tldpc.make_regular_ldpc(64, seed=1)
    np.testing.assert_array_equal(code.G[:64], np.eye(64))
    msg = np.random.default_rng(0).standard_normal((64, 3))
    assert code.check(code.encode(msg))
    with pytest.raises(ValueError, match="parity-only"):
        tldpc.make_parity_only_ldpc(64).encode(msg)


@pytest.mark.parametrize("bad", [dict(l=6, r=3), dict(l=3, r=5, K=21)])
def test_bad_degrees_raise(bad):
    K = bad.pop("K", 20)
    with pytest.raises(ValueError):
        tldpc.make_regular_ldpc(K, **bad)


@pytest.mark.parametrize("q0,l,r,D", [(0.1, 3, 6, 12), (0.25, 3, 6, 8),
                                      (0.45, 3, 6, 20), (0.3, 4, 8, 5)])
def test_density_evolution_identical(q0, l, r, D):
    np.testing.assert_array_equal(jde.qd_sequence(q0, l, r, D),
                                  tde.qd_sequence(q0, l, r, D))
    assert jde.q_final(q0, l, r, D) == tde.q_final(q0, l, r, D)


def test_threshold_identical():
    assert jde.threshold(3, 6) == tde.threshold(3, 6)
    assert abs(tde.threshold(3, 6) - 0.4294) < 1e-3
