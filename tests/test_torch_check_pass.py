"""The check pass and the one-round entry point of the port against the
JAX package's, on the CPU.

On CPU tensors ``repro_torch.kernels.ldpc_peel.check_pass_cuda`` runs the
kernel's plain version, ``ref.check_pass_ref``, and ``peel_round_cuda``
scatters its proposals in torch.  They are held here against

* the JAX Pallas ``check_pass`` in interpret mode (on inputs padded as
  tests/test_kernels.py pads them) and the JAX ``check_pass_ref``, on
  test_kernels.py's grid of (p, N, V): ``cnt``, ``pos`` and ``coeff``
  exactly, ``sums`` within 4 units of 2⁻²³·Σ_j|H[i, j]·known[j]| of each
  entry (the port sums in ascending column order, JAX's product in its
  own), and NaNs by position;
* JAX ``peel_round_pallas`` and JAX ``decoder.peel_round`` on test_kernels.py's
  codes (K in {20, 40, 100}, V in {1, 8, 64}) and on the (40, 20) code:
  erasure masks exactly, values within 1e-4·max|c| + 4·max(|JAX − c|,
  |port64 − c|) over the resolved coordinates, ``port64`` the same round
  in float64 (the anchored bound of the port's decode tests);
* a NaN and an inf in an erased entry: JAX multiplies them by 0 and every
  sum of the round turns NaN; so does the port's check pass (the port's
  DECODES never read erased entries, tests/test_torch_decode.py): NaN
  positions equal JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decoder as jdec
from repro.core.ldpc import make_regular_ldpc
from repro.kernels.ldpc_peel import peel_round_pallas
from repro.kernels.ldpc_peel.kernel import check_pass
from repro.kernels.ldpc_peel.ref import check_pass_ref as jax_check_pass_ref
from repro_torch.kernels.ldpc_peel import check_pass_cuda, check_pass_ref, peel_round_cuda


def _inputs(p, N, V, seed):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((p, N)).astype(np.float32)
    H[rng.random((p, N)) < 0.8] = 0.0
    vals = rng.standard_normal((N, V)).astype(np.float32)
    erased = rng.random(N) < 0.3
    return H, vals, erased


def _jax_pallas(H, vals, erased):
    """JAX check_pass in interpret mode, padded as tests/test_kernels.py pads."""
    p, N = H.shape
    V = vals.shape[1]

    def pad(x, m0, m1):
        return np.pad(x, ((0, (-x.shape[0]) % m0), (0, (-x.shape[1]) % m1)))

    bp = min(128, max(8, p))
    vp = pad(vals, 128, min(128, max(8, V)))
    out = check_pass(jnp.asarray(pad(H, bp, 128)), jnp.asarray(vp),
                     jnp.asarray(pad(erased.astype(np.float32)[:, None], 128, 1)), bp=bp,
                     bv=min(128, vp.shape[1]), interpret=True)
    return [np.asarray(o)[:p, :V] if i == 0 else np.asarray(o)[:p] for i, o in enumerate(out)]


def _sums_close(got, want, H, vals, erased):
    known = vals * (1.0 - erased.astype(np.float32))[:, None]
    tol = 4 * 2.0 ** -23 * (np.abs(H).astype(np.float64) @ np.abs(known)) + 1e-30
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert (np.abs(got[~nan] - want[~nan]) <= tol[~nan]).all()


@pytest.mark.parametrize("p,N,V", [(8, 16, 1), (32, 64, 4), (128, 256, 128),
                                   (130, 260, 7), (64, 128, 200)])
def test_check_pass_ref_matches_jax(p, N, V):
    H, vals, erased = _inputs(p, N, V, seed=p + N + V)
    got = check_pass_cuda(torch.from_numpy(H), torch.from_numpy(vals),
                          torch.from_numpy(erased))
    got = [g.numpy() for g in got]
    for want in (_jax_pallas(H, vals, erased),
                 [np.asarray(w) for w in jax_check_pass_ref(
                     jnp.asarray(H), jnp.asarray(vals),
                     jnp.asarray(erased.astype(np.float32)[:, None]))]):
        _sums_close(got[0], want[0], H, vals, erased)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
    assert got[2].dtype == np.int32 and (got[2] >= -1).all()


def test_check_pass_sums_in_ascending_column_order():
    # The plain version's sum is the kernel's chain: a rounded product and
    # a rounded add per column from +0, so it is not torch's own matmul.
    H, vals, erased = _inputs(32, 200, 3, seed=5)
    known = vals * (1.0 - erased.astype(np.float32))[:, None]
    want = np.zeros((32, 3), np.float32)
    for j in range(200):
        want = want + H[:, j, None] * known[None, j, :]
    sums = check_pass_ref(torch.from_numpy(H), torch.from_numpy(vals),
                          torch.from_numpy(erased.astype(np.float32)[:, None]))[0]
    assert np.array_equal(sums.numpy().view(np.int32), want.view(np.int32))


def _round_case(K, V, seed, f=0.25):
    code = make_regular_ldpc(K, l=3, r=6, seed=K)
    rng = np.random.default_rng(seed)
    cw = code.encode(rng.standard_normal((K, V))).astype(np.float32)
    erased = rng.random(code.N) < f
    rx = np.where(erased[:, None], 0.0, cw).astype(np.float32)
    return code, cw, rx, erased


def _round_agrees(code, cw, rx, erased, squeeze):
    H = np.ascontiguousarray(code.H, np.float32)
    tv = torch.from_numpy(rx[:, 0] if squeeze else rx)
    got_v, got_e = peel_round_cuda(torch.from_numpy(H), tv, torch.from_numpy(erased))
    jr = jnp.asarray(rx[:, 0] if squeeze else rx)
    pal_v, pal_e = peel_round_pallas(jnp.asarray(H), jr, jnp.asarray(erased), interpret=True)
    den_v, den_e = jdec.peel_round(jnp.asarray(H), jnp.asarray(code.H_mask), jnp.asarray(rx),
                                   jnp.asarray(erased))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(pal_e))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(den_e))
    # the anchor: the same round in float64 (the port's plain dense round)
    from repro_torch.core.decoder import peel_round as tround
    H64 = torch.from_numpy(code.H.astype(np.float64))
    a64, _ = tround(H64, H64 != 0, torch.from_numpy(rx).double(), torch.from_numpy(erased))
    got = got_v.numpy().reshape(rx.shape)
    resolved = erased & ~got_e.numpy()
    for want in (np.asarray(pal_v).reshape(rx.shape), np.asarray(den_v)):
        if not resolved.any():
            assert np.array_equal(got, want)
            continue
        anchor = max(np.abs(want - cw)[resolved].max(), np.abs(a64.numpy() - cw)[resolved].max())
        tol = 1e-4 * np.abs(cw).max() + 4 * anchor
        assert np.abs(got - want)[resolved].max() <= tol
        np.testing.assert_array_equal(got[~resolved], want[~resolved])
    return int(resolved.sum())


@pytest.mark.parametrize("K,V", [(20, 1), (40, 8), (100, 64)])
def test_peel_round_matches_jax_pallas_and_dense(K, V):
    code, cw, rx, erased = _round_case(K, V, seed=0)
    assert _round_agrees(code, cw, rx, erased, squeeze=V == 1) > 0


@pytest.mark.parametrize("f", [0.0, 0.25, 0.45])
def test_peel_round_on_the_40_20_code(f):
    code, cw, rx, erased = _round_case(20, 2, seed=7, f=f)
    _round_agrees(code, cw, rx, erased, squeeze=False)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_non_finite_erased_entries_propagate_as_in_jax(bad):
    code, cw, rx, erased = _round_case(20, 2, seed=3)
    j = int(np.flatnonzero(erased)[0])
    rx[j] = bad
    H = np.ascontiguousarray(code.H, np.float32)
    got_v, got_e = peel_round_cuda(torch.from_numpy(H), torch.from_numpy(rx),
                                   torch.from_numpy(erased))
    pal_v, pal_e = peel_round_pallas(jnp.asarray(H), jnp.asarray(rx), jnp.asarray(erased),
                                     interpret=True)
    den_v, _ = jdec.peel_round(jnp.asarray(H), jnp.asarray(code.H_mask), jnp.asarray(rx),
                               jnp.asarray(erased))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(pal_e))
    nan = np.isnan(got_v.numpy())
    np.testing.assert_array_equal(nan, np.isnan(np.asarray(pal_v)))
    np.testing.assert_array_equal(nan, np.isnan(np.asarray(den_v)))
    assert nan.sum() > 1                       # the resolved coordinates too
    np.testing.assert_array_equal(got_v.numpy()[~nan], np.asarray(pal_v)[~nan])


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    H, vals, erased = _inputs(16, 40, 2, seed=1)
    before = check_pass_cuda.launches
    got = check_pass_cuda(torch.from_numpy(H), torch.from_numpy(vals), torch.from_numpy(erased))
    want = check_pass_ref(torch.from_numpy(H), torch.from_numpy(vals),
                          torch.from_numpy(erased.astype(np.float32)[:, None]))
    assert check_pass_cuda.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("which", ["h_dtype", "values_shape", "erased_dtype", "noncontiguous",
                                   "rank", "empty"])
def test_check_pass_rejects_what_the_kernel_does_not_take(which):
    H, vals, erased = (torch.from_numpy(a) for a in _inputs(16, 40, 2, seed=2))
    if which == "h_dtype":
        H = H.double()
    elif which == "values_shape":
        vals = vals[:39].contiguous()
    elif which == "erased_dtype":
        erased = erased.to(torch.uint8)
    elif which == "noncontiguous":
        vals = vals.T.contiguous().T
    elif which == "rank":
        vals = vals[:, 0]
    else:
        vals = vals[:, :0]
    with pytest.raises(ValueError):
        check_pass_cuda(H, vals, erased)
