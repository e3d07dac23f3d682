"""The port's seeded codes, seeded encode and seeded Scheme 2 against the
JAX package's, on the CPU.

* The copy of the seeded section of ``core/ldpc.py`` must be bit-identical:
  structure constants, rows, H, G, neighbour tables and generator tables,
  and the same validation errors.
* The torch generator ``ref.seeded_rows`` (what the plain versions, and so
  the CUDA kernels, are held to) must be bit-identical to the NumPy one.
* The port's plain seeded decode must equal its plain table decode on the
  same ``make_seeded_ldpc`` code bit for bit, and a structure-only
  ``SeededLDPC`` the materialized code, for all four contracts.
  (tests/test_torch_seeded_decode.py holds the decodes against JAX.)
* Backend resolution follows the JAX rules for a seeded code.
* ``gather_encode`` must be bit-identical to JAX's EAGER ``gather_encode``:
  both are the unfused sequential chain, one rounded multiply and one
  rounded add per term.  JAX's jitted ``gather_encode`` and its Pallas
  ``encode_seeded`` (interpret mode) contract some of those multiply-adds
  into fused ones, so they are held to a bound: each of the ``r − 1``
  adds may round once less, so ``|port − jax| ≤ r·2⁻²³·Σ_s |w_s·y_s|``
  per entry (a few ulp of the absolute sum).
* ``Scheme2.build_seeded`` under ``run_pgd`` on JAX's straggler masks:
  unresolved counts exact, errors and iterates within 1e-4 relative (as in
  tests/test_torch_slice.py), and the fused and table encodes of the port
  bit-identical to each other.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_step as jcs
from repro.core import decoder as jdec
from repro.core import encoding as jenc
from repro.core import ldpc as jldpc
from repro.core.straggler import FixedCountStragglers as JaxFixedCount
from repro.data import make_linear_problem as jax_problem
from repro_torch import convert
from repro_torch.core import coded_step as tcs
from repro_torch.core import decoder as tdec
from repro_torch.core import encoding as tenc
from repro_torch.core import engine as teng
from repro_torch.core import ldpc as tldpc
from repro_torch.kernels.ldpc_peel import ops, ref

STRUCTS = [(256, 512, 8, 0), (1024, 2048, 8, 3), (96, 192, 6, 7), (16, 24, 3, 2**31 + 5),
           (8192, 16384, 8, 1), (4096, 1024, 8, 9)]


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(_bits(a), _bits(b))


# ------------------------------------------------------------ the ldpc copy

@pytest.mark.parametrize("rows,cols,rw,seed", STRUCTS)
def test_structure_and_rows_identical(rows, cols, rw, seed):
    js = jldpc.seeded_structure(rows, cols, rw, seed)
    ts = tldpc.seeded_structure(rows, cols, rw, seed)
    assert tuple(ts) == tuple(js) and ts._fields == js._fields
    for lo, hi in ((0, rows), (rows // 3, rows // 2 + 1), (rows - 1, rows), (5, 5)):
        for a, b in zip(tldpc._structure_rows_raw(ts, lo, hi),
                        jldpc._structure_rows_raw(js, lo, hi)):
            _same(a, b)
        for a, b in zip(tldpc.seeded_check_rows(ts, lo, hi),
                        jldpc.seeded_check_rows(js, lo, hi)):
            _same(a, b)
    hi = min(rows, 64)
    _same(tldpc.seeded_h_rows(ts, 0, hi), jldpc.seeded_h_rows(js, 0, hi))


@pytest.mark.parametrize("rows,cols,rw,seed", STRUCTS)
def test_torch_generator_identical(rows, cols, rw, seed):
    st = tldpc.seeded_structure(rows, cols, rw, seed)
    js = jldpc.seeded_structure(rows, cols, rw, seed)
    for lo, hi in ((0, rows), (rows // 3, rows // 2 + 1), (rows - 1, rows)):
        cols_t, w_t = ref.seeded_rows(st, lo, hi)
        cols_j, w_j = jldpc._structure_rows_raw(js, lo, hi)
        _same(cols_t.numpy().astype(np.int32), cols_j)
        _same(w_t.numpy(), w_j)
        idx_t, coeff_t = ref.seeded_table(st, lo, hi)
        idx_j, coeff_j = jldpc.seeded_check_rows(js, lo, hi)
        _same(idx_t.numpy().astype(np.int32), idx_j)
        _same(coeff_t.numpy(), coeff_j)


def test_the_hash_wraps_as_uint32():
    # every multiply of the hash overflows 32 bits somewhere in this range
    x = np.arange(0, 2**32, 2**32 // 100_003, dtype=np.uint64).astype(np.uint32)
    got = ref._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, jldpc._mix32(x).astype(np.int64))


def _same_code(a, b):
    for f in ("N", "K", "l", "r", "kind", "seed"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("H", "G", "check_idx", "check_coeff", "var_idx"):
        _same(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("K,l,r,seed", [(256, 4, 8, 0), (1024, 4, 8, 5), (96, 3, 6, 1)])
def test_make_seeded_ldpc_identical(K, l, r, seed):
    _same_code(tldpc.make_seeded_ldpc(K, l=l, r=r, seed=seed),
               jldpc.make_seeded_ldpc(K, l=l, r=r, seed=seed))


@pytest.mark.parametrize("K,p,rw,seed", [(64, 32, 8, 2), (512, 256, 8, 0), (96, 48, 6, 3)])
def test_make_seeded_ldgm_identical(K, p, rw, seed):
    tc = tldpc.make_seeded_ldgm(K, p, row_weight=rw, seed=seed)
    jc = jldpc.make_seeded_ldgm(K, p, row_weight=rw, seed=seed)
    _same_code(tc, jc)
    for lo, hi in ((0, tc.N), (K - 5, K + 7), (K + p - 3, K + p), (0, 3)):
        for a, b in zip(tldpc.seeded_generator_rows(tc, lo, hi),
                        jldpc.seeded_generator_rows(jc, lo, hi)):
            _same(a, b)


def test_structure_only_code_identical():
    t = tldpc.SeededLDPC(N=512, K=256, l=4, r=8, seed=4)
    j = jldpc.SeededLDPC(N=512, K=256, l=4, r=8, seed=4)
    assert (t.p, t.rate, t.kind) == (j.p, j.rate, j.kind)
    assert tuple(t.structure) == tuple(j.structure)
    for a, b in zip(t.check_rows(10, 90), j.check_rows(10, 90)):
        _same(a, b)
    assert tuple(tldpc.seeded_structure_of(t)) == tuple(jldpc.seeded_structure_of(j))
    assert tldpc.is_seeded(t) and not tldpc.is_seeded(tldpc.make_regular_ldpc(20))
    c = convert.code_from(j)
    assert isinstance(c, tldpc.SeededLDPC) and c == t


BAD = [
    ("seeded_structure", (0, 8, 2, 0), {}),
    ("seeded_structure", (8, 10, 4, 0), {}),
    ("seeded_structure", (6, 16, 4, 0), {}),
    ("SeededLDPC", (), dict(N=16, K=8, l=4, r=4)),
    ("SeededLDPC", (), dict(N=10, K=5, l=3, r=5)),
    ("SeededLDPC", (), dict(N=6, K=3, l=4, r=8)),
    ("make_seeded_ldpc", (3,), {}),
    ("make_seeded_ldpc", (20,), dict(l=3, r=6)),
    ("make_seeded_ldgm", (4, 4), dict(row_weight=8)),
    ("make_seeded_ldgm", (64, 12), dict(row_weight=8)),
    ("make_seeded_ldgm", (60, 30), dict(row_weight=8)),
]


@pytest.mark.parametrize("fn,args,kw", BAD)
def test_validation_errors_match_jax(fn, args, kw):
    with pytest.raises(ValueError) as want:
        getattr(jldpc, fn)(*args, **kw)
    with pytest.raises(ValueError) as got:
        getattr(tldpc, fn)(*args, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("which", ["rows_raw", "generator_range", "generator_kind",
                                   "structure_of"])
def test_range_and_kind_errors_match_jax(which):
    def call(mod):
        if which == "rows_raw":
            return mod._structure_rows_raw(mod.seeded_structure(64, 128, 8, 0), 0, 65)
        if which == "generator_range":
            return mod.seeded_generator_rows(mod.make_seeded_ldgm(64, 32), 0, 97)
        if which == "generator_kind":
            return mod.seeded_generator_rows(mod.make_seeded_ldpc(64), 0, 4)
        return mod.seeded_structure_of(mod.make_regular_ldpc(20))

    with pytest.raises(ValueError) as want:
        call(jldpc)
    with pytest.raises(ValueError) as got:
        call(tldpc)
    if which == "structure_of":       # the message names each package's backend
        assert "kind='ldpc'" in str(got.value) and "kind='ldpc'" in str(want.value)
    else:
        assert str(got.value) == str(want.value)


# ------------------------------------------------- plain decodes, both codes

@functools.cache
def _seeded_code(K=256):
    return tldpc.make_seeded_ldpc(K, seed=2)


def _decode_inputs(N, batch, f, V=2, seed=0):
    rng = np.random.default_rng([N, batch, int(f * 100), V, seed])
    e = rng.random((batch, N)) < f
    v = rng.standard_normal((batch, N, V)).astype(np.float32)
    return torch.from_numpy(np.where(e[..., None], 1e3 * v, v)), torch.from_numpy(e)


def _contracts(code, v, e, backend):
    budgets = torch.tensor([0, 2, 8, code.N][:v.shape[0]], dtype=torch.int32)
    return [tdec.peel_decode(code, v[0], e[0], 8, backend=backend),
            tdec.peel_decode_batch(code, v, e, 8, backend=backend),
            tdec.peel_decode_adaptive(code, v[0], e[0], 8, backend=backend),
            tdec.peel_decode_batch_adaptive(code, v, e, backend=backend, budgets=budgets)]


def _all_same(xs, ys):
    for x, y in zip(xs, ys):
        _same(x.values.numpy(), y.values.numpy())
        _same(x.erased.numpy(), y.erased.numpy())
        _same(np.asarray(x.rounds_used), np.asarray(y.rounds_used))


@pytest.mark.parametrize("f", [0.0, 0.25, 0.45])
def test_seeded_plain_equals_table_plain(f):
    code = _seeded_code()
    v, e = _decode_inputs(code.N, 4, f)
    _all_same(_contracts(code, v, e, "cuda_seeded"), _contracts(code, v, e, "cuda"))


@pytest.mark.parametrize("f", [0.0, 0.25, 0.45])
def test_structure_only_equals_materialized(f):
    code = _seeded_code()
    bare = tldpc.SeededLDPC(N=code.N, K=code.K, l=code.l, r=code.r, seed=code.seed)
    v, e = _decode_inputs(code.N, 4, f, seed=1)
    _all_same(_contracts(bare, v, e, "auto"), _contracts(code, v, e, "auto"))


def test_table_round_matches_dense_round_on_a_padded_table():
    # a code whose rows differ in weight pads its table with the column N
    code = tldpc.make_seeded_ldgm(64, 32, seed=3)
    H = ref.dense_h(torch.from_numpy(code.check_idx), torch.from_numpy(code.check_coeff),
                    code.N)
    v, e = _decode_inputs(code.N, 3, 0.3, V=1)
    idx, w = ref._row_table(H)
    for _ in range(3):
        a = ref.lo_round(H, v, e)
        b = ref.table_round(idx.T, w.T, v, e)
        _same(a[0].numpy(), b[0].numpy())
        _same(a[1].numpy(), b[1].numpy())
        v, e = a


def test_seeded_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    code = _seeded_code()
    st = tdec.seeded_spec(code)
    v, e = _decode_inputs(code.N, 2, 0.3)
    wrappers = (ops.peel_decode_seeded_cuda, ops.peel_decode_batch_seeded_cuda,
                ops.peel_decode_adaptive_seeded_cuda,
                ops.peel_decode_batch_adaptive_seeded_cuda, ops.encode_seeded_fused_cuda)
    before = [w.launches for w in wrappers]
    _same(ops.peel_decode_batch_seeded_cuda(st, v, e, 5)[0].numpy(),
          ref.decode_seeded_batch_ref(st, v, e, 5)[0].numpy())
    _contracts(code, v, e, "auto")
    gst = tenc.generator_structure_of(tldpc.make_seeded_ldgm(64, 32))
    ops.encode_seeded_fused_cuda(gst, torch.ones((64, 1)))
    assert [w.launches for w in wrappers] == before == [0] * 5


@pytest.mark.parametrize("bad", ["dtype", "erased_dtype", "shape", "noncontiguous",
                                 "iters", "budget_dtype", "row_weight", "layers"])
def test_seeded_wrappers_reject_what_the_kernel_does_not_take(bad):
    st = tdec.seeded_spec(_seeded_code())
    N = st.cols
    v = torch.zeros((2, N, 3))
    e = torch.zeros((2, N), dtype=torch.bool)
    budgets = torch.zeros(2, dtype=torch.int32)
    iters = 3
    if bad == "dtype":
        v = v.double()
    elif bad == "erased_dtype":
        e = e.to(torch.uint8)
    elif bad == "shape":
        v = torch.zeros((2, N + 1, 3))
    elif bad == "noncontiguous":
        v = torch.zeros((2, 3, N)).transpose(1, 2)
    elif bad == "iters":
        iters = -1
    elif bad == "budget_dtype":
        budgets = budgets.long()
    elif bad == "row_weight":
        st = st._replace(row_weight=0)
    else:                        # layers that do not split the rows
        st = st._replace(layers=st.layers + 1)
    with pytest.raises(ValueError):
        if bad == "budget_dtype":
            ops.peel_decode_batch_adaptive_seeded_cuda(st, v, e, budgets)
        else:
            ops.peel_decode_batch_seeded_cuda(st, v, e, iters)


@pytest.mark.parametrize("bad", ["dtype", "shape", "row0", "n_out", "noncontiguous"])
def test_encode_wrapper_rejects_what_the_kernel_does_not_take(bad):
    st = tenc.generator_structure_of(tldpc.make_seeded_ldgm(64, 32))
    y, row0, n_out = torch.zeros((64, 2)), 0, None
    if bad == "dtype":
        y = y.double()
    elif bad == "shape":
        y = torch.zeros((63, 2))
    elif bad == "row0":
        row0 = -1
    elif bad == "n_out":
        n_out = 0
    else:
        y = torch.zeros((2, 64)).T
    with pytest.raises(ValueError):
        ops.encode_seeded_fused_cuda(st, y, row0, n_out)


# ------------------------------------------------------- backend resolution

def _kinds():
    return {"regular": (jldpc.make_regular_ldpc(20), tldpc.make_regular_ldpc(20)),
            "seeded": (jldpc.make_seeded_ldpc(64), tldpc.make_seeded_ldpc(64)),
            "bare": (jldpc.SeededLDPC(N=128, K=64, l=4, r=8),
                     tldpc.SeededLDPC(N=128, K=64, l=4, r=8)),
            "ldgm": (jldpc.make_seeded_ldgm(64, 32), tldpc.make_seeded_ldgm(64, 32))}


# the port's backends and the JAX backend each stands for
PAIRS = [("cuda_seeded", "pallas_seeded"), ("cuda", "pallas"), ("dense", "dense")]


@pytest.mark.parametrize("kind", ["regular", "seeded", "bare", "ldgm"])
@pytest.mark.parametrize("port,jax_name", PAIRS)
def test_backend_errors_mirror_jax(kind, port, jax_name):
    jc, tc = _kinds()[kind]
    try:
        jdec.resolve_backend(jax_name, jc)
        jax_raises = False
    except ValueError:
        jax_raises = True
    if jax_raises:
        with pytest.raises(ValueError):
            tdec.resolve_backend(port, tc)
        with pytest.raises(ValueError):
            teng.CodedComputeEngine(tc, backend=port)
    else:
        assert tdec.resolve_backend(port, tc) == port


@pytest.mark.parametrize("kind,want", [("regular", "cuda"), ("seeded", "cuda_seeded"),
                                       ("bare", "cuda_seeded"), ("ldgm", "cuda")])
def test_auto_picks_the_seeded_kernel_for_seeded_codes(kind, want):
    jc, tc = _kinds()[kind]
    assert tdec.resolve_backend("auto", tc) == want
    assert teng.CodedComputeEngine(tc).backend == "auto"
    if kind == "bare":        # the JAX rule on every platform
        assert jdec.resolve_backend("auto", jc) == "pallas_seeded"
    # without a code, "auto" is the table kernel as before
    assert tdec.resolve_backend("auto") == "cuda"


def test_engine_encode_needs_a_generator():
    for kind in ("seeded", "bare"):
        _, tc = _kinds()[kind]
        with pytest.raises(ValueError, match="no generator"):
            teng.CodedComputeEngine(tc).encode(torch.ones((tc.K, 2)))


def test_engine_stages_run_on_a_structure_only_code():
    _, bare = _kinds()["bare"]
    code = tldpc.make_seeded_ldpc(64)
    v, e = _decode_inputs(bare.N, 3, 0.3, V=1, seed=4)
    for eng_kw in ({}, {"adaptive": True}):
        a = teng.CodedComputeEngine(bare, decode_iters=6, **eng_kw)
        b = teng.CodedComputeEngine(code, decode_iters=6, **eng_kw)
        for x, y in ((a.recover(v[0], e[0]), b.recover(v[0], e[0])),
                     (a.recover_batch(v, e), b.recover_batch(v, e))):
            _same(x[0].numpy(), y[0].numpy())
            _same(x[1].numpy(), y[1].numpy())
        assert a.systematic(a.decode(v[0], e[0]))[0].shape == (bare.K, 1)


# ------------------------------------------------------------------- encode

@functools.cache
def _ldgm(K=512, p=256, seed=5):
    jc = jldpc.make_seeded_ldgm(K, p, seed=seed)
    return jc, convert.code_from(jc)


def _payload(K, V, seed=0):
    y = np.random.default_rng([K, V, seed]).standard_normal((K, V)).astype(np.float32)
    y[0, 0] = -0.0
    return y


@pytest.mark.parametrize("V", [None, 1, 4])
def test_gather_encode_bit_identical_to_jax_eager(V):
    jc, tc = _ldgm()
    y = _payload(jc.K, V or 1)
    y = y[:, 0] if V is None else y
    idx, coeff = jldpc.seeded_generator_rows(jc, 0, jc.N)
    with jax.disable_jit():
        want = np.asarray(jenc.gather_encode(jnp.asarray(idx), jnp.asarray(coeff),
                                             jnp.asarray(y)))
    got = tenc.gather_encode(*tenc.generator_gather_tables(tc, "cpu"), torch.from_numpy(y))
    _same(got.numpy(), want)


@pytest.mark.parametrize("V", [1, 4])
def test_gather_encode_within_fma_bound_of_jax_jit_and_fused(V):
    jc, tc = _ldgm()
    y = _payload(jc.K, V, seed=1)
    idx, coeff = jldpc.seeded_generator_rows(jc, 0, jc.N)
    got = tenc.gather_encode(*tenc.generator_gather_tables(tc, "cpu"),
                             torch.from_numpy(y)).numpy()
    bound = idx.shape[1] * 2.0 ** -23 * np.einsum(
        "nr,nrv->nv", np.abs(coeff), np.abs(y[idx]))
    jitted = np.asarray(jax.jit(jenc.gather_encode)(jnp.asarray(idx), jnp.asarray(coeff),
                                                    jnp.asarray(y)))
    fused = np.asarray(jenc.encode_seeded(jc, jnp.asarray(y)))
    for want in (jitted, fused):
        assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("row0,n_out", [(0, None), (100, 300), (500, 40), (700, 200),
                                        (768, 5), (900, 9)])
def test_encode_seeded_equals_gather_encode_over_windows(row0, n_out):
    jc, tc = _ldgm()
    y = torch.from_numpy(_payload(jc.K, 3, seed=2))
    n = jc.N if n_out is None else n_out
    got = tenc.encode_seeded(tc, y, row0, n_out=n_out)
    lo, hi = min(row0, jc.N), min(row0 + n, jc.N)
    idx, coeff = jldpc.seeded_generator_rows(jc, lo, hi)
    want = tenc.gather_encode(torch.from_numpy(idx), torch.from_numpy(coeff), y)
    assert got.shape == (n, 3)
    _same(got[:hi - lo].numpy(), want.numpy())
    assert (got[hi - lo:] == 0).all()


def test_encode_seeded_squeezes_and_keeps_the_pad_terms():
    _, tc = _ldgm()
    y = torch.ones(tc.K)
    y[0] = float("inf")
    z = tenc.encode_seeded(tc, y)
    assert z.shape == (tc.N,)
    assert bool(torch.isnan(z[1:tc.K]).all())     # 0·y[0] in every systematic row
    _same(z.numpy(), tenc.gather_encode(*tenc.generator_gather_tables(tc, "cpu"), y).numpy())


def test_encode_moment_seeded_matches_jax():
    jc, tc = _ldgm(64, 32, 1)
    M = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jenc.encode_moment_seeded(jc, jnp.asarray(M)))
    got = tenc.encode_moment_seeded(tc, torch.from_numpy(M))
    _same(got.numpy(), want)
    dense = tenc.encode_moment(tc, torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=1e-5 * np.abs(M).max())
    with pytest.raises(ValueError, match="code dimension"):
        tenc.encode_moment_seeded(tc, torch.zeros((32, 32)))


def test_generator_structure_errors_match_jax():
    for make in (lambda m: m.make_seeded_ldpc(64), lambda m: m.make_regular_ldpc(20)):
        with pytest.raises(ValueError) as want:
            jenc.generator_structure_of(make(jldpc))
        with pytest.raises(ValueError) as got:
            tenc.generator_structure_of(make(tldpc))
        assert str(got.value) == str(want.value)
    jc, tc = _ldgm()
    assert tuple(tenc.generator_structure_of(tc)) == tuple(jenc.generator_structure_of(jc))


# ------------------------------------------------------ seeded Scheme 2

K_S, P_S, STEPS, S, D = 64, 32, 10, 30, 8


@functools.cache
def _scheme_setup():
    prob = jax_problem(256, K_S, seed=0)
    code = jldpc.make_seeded_ldgm(K_S, P_S, seed=1)
    return prob, code, jenc.second_moment(prob.X, prob.y)


@functools.cache
def _masks(seed=1):
    keys = jax.random.split(jax.random.PRNGKey(seed), STEPS)
    return np.array(jax.vmap(lambda k: JaxFixedCount(S).sample(k, K_S + P_S))(keys))


@functools.cache
def _jax_run(fused):
    prob, code, mom = _scheme_setup()
    scheme = jcs.Scheme2.build_seeded(code, mom, lr=prob.lr, decode_iters=D,
                                      encode_fused=fused, decode_backend="pallas")
    res = jcs.run_pgd(scheme, jnp.zeros(K_S), JaxFixedCount(S), STEPS,
                      key=jax.random.PRNGKey(1), theta_star=prob.theta_star)
    return scheme, res


def _port_scheme(scheme, fused):
    return convert.scheme2_from_arrays(
        convert.code_from(scheme.code), scheme.C, scheme.b, scheme.lr, D, device="cpu",
        seeded_encode=True, encode_fused=fused)


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("fused", [False, True])
def test_run_pgd_seeded_matches_jax(fused):
    prob, _, _ = _scheme_setup()
    scheme, want = _jax_run(fused)
    port = _port_scheme(scheme, fused)
    got = tcs.run_pgd(port, torch.zeros(K_S), None, STEPS,
                      masks=torch.from_numpy(_masks()),
                      theta_star=convert.tensor(prob.theta_star, "cpu"))
    np.testing.assert_array_equal(got.unresolved.numpy(), np.asarray(want.unresolved))
    assert np.asarray(want.unresolved).sum() > 0      # the decode had work
    _close(got.errors.numpy(), want.errors)
    _close(got.theta.numpy(), want.theta)
    _close(got.theta_bar.numpy(), want.theta_bar)
    assert float(got.errors[-1]) < float(got.errors[0])


def test_fused_and_table_encodes_give_identical_runs():
    prob, _, _ = _scheme_setup()
    scheme, _ = _jax_run(True)
    runs = [tcs.run_pgd(_port_scheme(scheme, fused), torch.zeros(K_S), None, STEPS,
                        masks=torch.from_numpy(_masks()),
                        theta_star=convert.tensor(prob.theta_star, "cpu"))
            for fused in (False, True)]
    for a, b in zip(*runs):
        _same(a.numpy(), b.numpy())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_gradient_batch_seeded_matches_jax(fused, adaptive):
    prob, code, mom = _scheme_setup()
    scheme = jcs.Scheme2.build_seeded(code, mom, lr=prob.lr, decode_iters=3,
                                      encode_fused=fused, adaptive=adaptive,
                                      decode_backend="pallas")
    rng = np.random.default_rng(7)
    theta = rng.standard_normal((5, K_S)).astype(np.float32)
    mask = rng.random((5, code.N)) < np.array([0.05, 0.2, 0.3, 0.4, 0.5])[:, None]
    wg, wu = scheme.gradient_batch(jnp.asarray(theta), jnp.asarray(mask))
    port = dataclasses.replace(_port_scheme(scheme, fused), decode_iters=3,
                               adaptive=adaptive)
    tg, tu = port.gradient_batch(torch.from_numpy(theta), torch.from_numpy(mask))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(wu))
    assert np.asarray(wu).sum() > 0
    _close(tg.numpy(), wg)
    for b in range(5):                  # each query as gradient() gives it alone
        g1, u1 = port.gradient(torch.from_numpy(theta[b]), torch.from_numpy(mask[b]))
        assert int(u1) == int(tu[b])


def test_build_seeded_stores_the_moment():
    prob, code, mom = _scheme_setup()
    tc = convert.code_from(code)
    M, b = torch.from_numpy(np.array(mom.M)), torch.from_numpy(np.array(mom.b))
    s = tcs.Scheme2.build_seeded(tc, tenc.Moments(M, b), lr=0.1, decode_iters=4)
    assert s.seeded_encode and not s.encode_fused and s.C is M
    assert s.engine.backend == "auto" and tdec.resolve_backend("auto", tc) == "cuda"


# ---------------------------------------------- past the kernels' old caps
# The seeded kernels once took row weight and layer count up to 16 only.
# The wrappers now take any (on CPU tensors they run the plain versions,
# which the card tests hold the kernels to bit for bit).

@pytest.mark.parametrize("K,p,rw", [(192, 96, 24), (64, 160, 8)],
                         ids=["row_weight_24", "layers_20"])
def test_encode_past_the_old_caps_matches_jax(K, p, rw):
    jc = jldpc.make_seeded_ldgm(K, p, row_weight=rw, seed=3)
    tc = convert.code_from(jc)
    st = tenc.generator_structure_of(tc)
    assert (st.row_weight, st.layers) == (rw, p * rw // K)
    y = _payload(K, 2, seed=4)
    idx, coeff = jldpc.seeded_generator_rows(jc, 0, jc.N)
    with jax.disable_jit():
        eager = np.asarray(jenc.gather_encode(jnp.asarray(idx), jnp.asarray(coeff),
                                              jnp.asarray(y)))
    got = ops.encode_seeded_fused_cuda(st, torch.from_numpy(y)).numpy()
    _same(got, eager)
    fused = np.asarray(jenc.encode_seeded(jc, jnp.asarray(y)))
    bound = idx.shape[1] * 2.0 ** -23 * np.einsum(
        "nr,nrv->nv", np.abs(coeff), np.abs(y[idx]))
    assert (np.abs(got - fused) <= bound).all()


def test_decode_wrappers_past_the_old_caps_equal_the_table_decode():
    code = tldpc.make_seeded_ldpc(64, l=20, r=24, seed=1)
    st = tdec.seeded_spec(code)
    assert (st.row_weight, st.layers) == (24, 20)
    v, e = _decode_inputs(code.N, 2, 0.2)
    tables = tdec.code_tables(code, "cpu")
    budgets = torch.tensor([3, code.N], dtype=torch.int32)
    for got, want in (
            (ops.peel_decode_batch_seeded_cuda(st, v, e, 8),
             ref.decode_table_batch_ref(tables.check_idx, tables.check_coeff, v, e, 8)),
            (ops.peel_decode_batch_adaptive_seeded_cuda(st, v, e, budgets),
             ref.decode_table_batch_adaptive_ref(tables.check_idx, tables.check_coeff,
                                                 v, e, budgets))):
        for a, b in zip(got, want):
            _same(a.numpy(), b.numpy())
    assert bool((e & ~got[1]).any())
