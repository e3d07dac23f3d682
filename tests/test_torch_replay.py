"""Schedule replay in the port against the JAX package's, and the table
decode's plain version at any N.

Bottom up:

* the host schedule (``PeelSchedule``, ``compile_peel_schedule``) equals
  JAX's field by field under both tie-break rules, and the probe-round rule
  (``_replay_rounds_used``) equals JAX's;
* the replay's plain version (what ``backend="replay"`` runs on CPU tensors,
  and what the CUDA replay kernel is held against on the card) equals JAX
  ``peel_decode*(backend="replay")`` — the XLA replay executors — on all
  four contracts, and JAX's Pallas ``decode_replay`` in interpret mode under
  each rule;
* the ``ScheduleCache`` copy, the engine's and ``Scheme2``'s cache
  threading, and the continuous ``CodedQueryBatcher`` with replay against
  the JAX replay batcher;
* the table decode's gather plain version (which the table kernel's
  wrappers now run on CPU tensors) against the dense one, and against JAX
  ``sparse`` at N = 4096.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are exact unless stated: floats are compared as bit patterns
(signed zeros included), masks, rounds and counts by value.  NaNs are
compared by position only: erased entries here hold NaN and inf, which
the replay multiplies by its zero weight as JAX's executors do, and IEEE
754 leaves to the implementation which input NaN's sign and payload an
operation on two NaNs returns (XLA and eager torch differ there).  Replay is bit-identical by construction — the same schedule, and
every resolving sum the same Neumaier chain of rounded f32 operations.
Gradients through the batcher also go through each package's own f32
worker products, so they are held to the anchored bound of ROADMAP
queue 3: ``|g_port − g_ref| ≤ 1e-4·max|g_ref| + 4·max(|g_ref − g_exact|,
|g64 − g_exact|)``, ``g64`` the port's worker products decoded in float64
under the same tie-break.
"""
import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_step as jcs
from repro.core import decoder as jdec
from repro.core import ldpc as jldpc
from repro.core import schedule_cache as jsc
from repro.core.encoding import second_moment as jax_second_moment
from repro.core.engine import CodedComputeEngine as JaxEngine
from repro.data import make_linear_problem as jax_problem
from repro.kernels.ldpc_peel import peel_decode_replay_pallas
from repro.serving import coded_queries as jcq
from repro_torch import convert
from repro_torch.core import ScheduleCache, decoder as tdec
from repro_torch.core.engine import CodedComputeEngine
from repro_torch.core.ldpc import SeededLDPC, make_regular_ldpc
from repro_torch.kernels.ldpc_peel import (ReplayPack, dense_h, ops,
                                           peel_decode_replay_cuda, ref)
from repro_torch.serving import CodedQuery, CodedQueryBatcher


@functools.cache
def _codes(name):
    """(JAX code, port code): the (40, 20) code, and (3, 6) codes at K =
    256 with Gaussian and ±1 weights."""
    if name == "40x20":
        jc = jldpc.make_regular_ldpc(20, seed=0)
    else:
        jc = jldpc.make_parity_only_ldpc(256, seed=0, values=name)
    return jc, convert.code_from(jc)


def _bits(a) -> np.ndarray:
    """Bit patterns, every NaN mapped to one quiet NaN."""
    a = np.asarray(a, np.float32)
    return np.ascontiguousarray(np.where(np.isnan(a), np.float32(np.nan), a)).view(np.int32)


def _assert_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _inputs(code, B, V, fs, seed, specials=True):
    """``(values (B, N, V), erased (B, N))``: integer payloads on ±1 codes
    (every step exact) or Gaussian ones; erased entries hold large garbage,
    and slot 0's first three erased entries NaN, inf and -0.0."""
    rng = np.random.default_rng(seed)
    erased = rng.random((B, code.N)) < np.asarray(fs)[:, None]
    if code.kind == "ldpc-parity-only" and np.all(np.abs(code.H[code.H != 0]) == 1):
        vals = rng.integers(-8, 9, (B, code.N, V)).astype(np.float32)
    else:
        vals = rng.standard_normal((B, code.N, V)).astype(np.float32)
    vals = np.where(erased[..., None], np.float32(1e3), vals)
    if specials:
        pos = np.flatnonzero(erased[0])[:3]
        vals[0, pos] = np.array([np.nan, np.inf, -0.0], np.float32)[:len(pos), None]
    return vals, erased


# ------------------------------------------------------- the host schedule

FIELDS = ("N", "r_max", "n_erased", "n_rounds", "n_resolved", "fully_resolved",
          "offsets", "target", "idx_lo", "w_lo", "coeff_lo", "idx_hi", "w_hi",
          "coeff_hi", "mask_key")


@pytest.mark.parametrize("name", ["40x20", "gaussian", "pm1"])
@pytest.mark.parametrize("q", [0.0, 0.25, 0.45])
def test_schedule_equals_jax_field_by_field(name, q):
    jc, tc = _codes(name)
    erased = np.random.default_rng([7, int(q * 100)]).random(jc.N) < q
    js = jdec.compile_peel_schedule(jc, erased)
    ts = tdec.compile_peel_schedule(tc, torch.from_numpy(erased))
    for f in FIELDS:
        a, b = getattr(ts, f), getattr(js, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                          b.view(np.int32) if b.dtype == np.float32 else b,
                                          err_msg=f)
        else:
            assert a == b, f
    # the same mask as numpy or as a tensor gives the same key
    assert tdec.erasure_mask_key(erased) == tdec.erasure_mask_key(torch.from_numpy(erased))


def test_compile_schedule_errors():
    _, tc = _codes("40x20")
    with pytest.raises(ValueError, match="LDPCCode"):
        tdec.compile_peel_schedule(SeededLDPC(N=64, K=32, l=4, r=8), np.zeros(64, bool))
    with pytest.raises(ValueError, match="erased must be"):
        tdec.compile_peel_schedule(tc, np.zeros(tc.N + 1, bool))


def _patterns(code):
    """(mask, fully resolves?) — nothing erased, a pattern that fully
    resolves, and one past the threshold that does not."""
    rng = np.random.default_rng(11)
    none = np.zeros(code.N, bool)
    light = rng.random(code.N) < 0.15
    heavy = rng.random(code.N) < 0.6
    return {"none": none, "resolves": light, "stuck": heavy}


@pytest.mark.parametrize("kind", ["none", "resolves", "stuck"])
def test_probe_rule_equals_jax(kind):
    jc, tc = _codes("gaussian")
    mask = _patterns(tc)[kind]
    js = jdec.compile_peel_schedule(jc, mask)
    ts = tdec.compile_peel_schedule(tc, mask)
    assert ts.fully_resolved == (kind != "stuck")
    R = ts.n_rounds
    v = torch.zeros((tc.N, 1))
    for budget in sorted({0, 1, max(R - 1, 0), R, R + 1}):
        want = int(jdec._replay_rounds_used(js, budget))
        assert tdec._replay_rounds_used(ts, budget) == want, budget
        # the replay computes the same count on the values' device, and so
        # does the flooding decode's early exit
        got = tdec.peel_decode_adaptive(tc, v, torch.from_numpy(mask), budget,
                                        backend="replay", schedule=ts)
        flood = tdec.peel_decode_adaptive(tc, v, torch.from_numpy(mask), budget,
                                          backend="cuda")
        assert int(got.rounds_used) == int(flood.rounds_used) == want, budget
        assert torch.equal(got.erased, flood.erased)


# ------------------------------------------------------- replay values

@pytest.mark.parametrize("name", ["40x20", "pm1"])
@pytest.mark.parametrize("D", [0, 1, 3, 8])
def test_replay_equals_jax_executors(name, D):
    jc, tc = _codes(name)
    vals, erased = _inputs(tc, 4, 2, [0.3, 0.1, 0.45, 0.0], [D, len(name)])
    tv, te = torch.from_numpy(vals), torch.from_numpy(erased)
    for j, t in (
            (jdec.peel_decode(jc, vals[0], erased[0], D, backend="replay"),
             tdec.peel_decode(tc, tv[0], te[0], D, backend="replay")),
            (jdec.peel_decode_adaptive(jc, vals[0], erased[0], D, backend="replay"),
             tdec.peel_decode_adaptive(tc, tv[0], te[0], D, backend="replay")),
            (jdec.peel_decode_batch(jc, vals, erased, D, backend="replay"),
             tdec.peel_decode_batch(tc, tv, te, D, backend="replay"))):
        _assert_bits(t.values.numpy(), j.values)
        np.testing.assert_array_equal(t.erased.numpy(), np.asarray(j.erased))
        np.testing.assert_array_equal(np.asarray(t.rounds_used), np.asarray(j.rounds_used))


@pytest.mark.parametrize("name", ["40x20", "pm1"])
def test_replay_batch_adaptive_equals_jax(name):
    jc, tc = _codes(name)
    vals, erased = _inputs(tc, 4, 3, [0.3, 0.1, 0.45, 0.42], 5)
    budgets = np.array([8, 1, 3, 8], np.int32)
    j = jdec.peel_decode_batch_adaptive(jc, vals, erased, backend="replay",
                                        budgets=jnp.asarray(budgets))
    t = tdec.peel_decode_batch_adaptive(tc, torch.from_numpy(vals),
                                        torch.from_numpy(erased), backend="replay",
                                        budgets=torch.from_numpy(budgets))
    _assert_bits(t.values.numpy(), j.values)
    np.testing.assert_array_equal(t.erased.numpy(), np.asarray(j.erased))
    np.testing.assert_array_equal(t.rounds_used.numpy(), np.asarray(j.rounds_used))
    assert t.rounds_used.dtype == torch.int32


@pytest.mark.parametrize("rule", ["hi", "lo"])
def test_replay_equals_pallas_kernel(rule):
    # the (3, 6) code at K = 128: N = 256, Pallas in interpret mode
    jc = jldpc.make_parity_only_ldpc(128, seed=3)
    tc = convert.code_from(jc)
    vals, erased = _inputs(tc, 1, 2, [0.35], 9)
    js = jdec.compile_peel_schedule(jc, erased[0])
    jv, je = peel_decode_replay_pallas(js, jnp.asarray(vals[0]), jnp.asarray(erased[0]),
                                       rule=rule, interpret=True, bv=8)
    ts = tdec.compile_peel_schedule(tc, erased[0])
    tv, te, _ = tdec._replay([ts], rule, torch.from_numpy(vals), torch.from_numpy(erased),
                             ts.n_rounds)
    _assert_bits(tv[0].numpy(), jv)
    np.testing.assert_array_equal(te[0].numpy(), np.asarray(je))


def test_replay_checks_its_schedule():
    _, tc = _codes("40x20")
    v = torch.zeros((tc.N, 1))
    e1 = torch.from_numpy(np.random.default_rng(5).random(tc.N) < 0.25)
    e2 = torch.from_numpy(np.random.default_rng(6).random(tc.N) < 0.25)
    sched = tdec.compile_peel_schedule(tc, e1)
    with pytest.raises(ValueError, match="does not match the erasure mask"):
        tdec.peel_decode(tc, v, e2, 8, backend="replay", schedule=sched)
    with pytest.raises(ValueError, match="does not match the erasure mask"):
        tdec.peel_decode_batch_adaptive(tc, v.T.expand(2, -1).contiguous(),
                                        torch.stack([e1, e2]), 8, backend="replay",
                                        schedules=(sched, sched))
    other = make_regular_ldpc(24, seed=1)
    with pytest.raises(ValueError, match="solved for N"):
        tdec.peel_decode(other, torch.zeros(other.N), torch.zeros(other.N, dtype=torch.bool),
                         8, backend="replay", schedule=sched)
    with pytest.raises(ValueError, match="length 2"):
        tdec.peel_decode_batch(tc, v.T.expand(2, -1).contiguous(), torch.stack([e1, e1]),
                               8, backend="replay", schedules=(sched,))
    for backend in ("cuda", "dense", "auto"):
        with pytest.raises(ValueError, match="only meaningful"):
            tdec.peel_decode(tc, v, e1, 8, backend=backend, schedule=sched)
        with pytest.raises(ValueError, match="only meaningful"):
            tdec.peel_decode_batch(tc, v.T, e1[None], 8, backend=backend,
                                   schedules=(sched,))


def test_replay_backend_resolution():
    _, tc = _codes("40x20")
    assert "replay" in tdec.BACKENDS
    assert tdec.resolve_backend("replay", tc) == "replay"
    assert tdec.resolve_backend("auto", tc) == "cuda"           # never replay
    with pytest.raises(ValueError, match="structure-only"):
        tdec.resolve_backend("replay", SeededLDPC(N=64, K=32, l=4, r=8))
    with pytest.raises(ValueError, match="structure-only"):
        CodedComputeEngine(SeededLDPC(N=64, K=32, l=4, r=8), backend="replay")


def test_replay_packs_are_built_once_and_joined_on_the_device():
    _, tc = _codes("40x20")
    masks = np.random.default_rng(3).random((3, tc.N)) < 0.3
    scheds = [tdec.compile_peel_schedule(tc, m) for m in masks]
    a = tdec._replay_pack(scheds[0], "lo", torch.device("cpu"))
    assert tdec._replay_pack(scheds[0], "lo", torch.device("cpu")) is a
    assert a.meta.tolist() == [[scheds[0].n_resolved, scheds[0].n_rounds,
                                tdec._replay_rounds_used(scheds[0], tc.N)]]
    # three slots, one launch: the same as each slot alone
    vals, erased = _inputs(tc, 3, 2, [0.3, 0.3, 0.3], 4, specials=False)
    erased = masks
    v, e = torch.from_numpy(vals), torch.from_numpy(erased)
    budgets = torch.tensor([2, 0, 9], dtype=torch.int32)
    jv, je, jr = tdec._replay(scheds, "lo", v, e, budgets)
    for b, s in enumerate(scheds):
        ov, oe, orr = tdec._replay([s], "lo", v[b:b + 1], e[b:b + 1], budgets[b:b + 1])
        assert torch.equal(jv[b].view(torch.int32), ov[0].view(torch.int32))
        assert torch.equal(je[b], oe[0]) and int(jr[b]) == int(orr[0])


def test_replay_wrapper_validates_and_counts_nothing_on_cpu():
    _, tc = _codes("40x20")
    s = tdec.compile_peel_schedule(tc, np.random.default_rng(2).random(tc.N) < 0.3)
    pack = tdec._replay_pack(s, "hi", torch.device("cpu"))
    v = torch.zeros((1, tc.N, 2))
    e = torch.from_numpy(np.unpackbits(np.frombuffer(s.mask_key, np.uint8))[:tc.N]
                         .astype(bool))[None]
    before = peel_decode_replay_cuda.launches
    peel_decode_replay_cuda(pack, v, e, 4)
    assert peel_decode_replay_cuda.launches == before == 0
    with pytest.raises(ValueError, match="meta"):
        peel_decode_replay_cuda(pack, v.expand(2, -1, -1).contiguous(),
                                e.expand(2, -1).contiguous(), 4)
    with pytest.raises(ValueError):
        peel_decode_replay_cuda(pack._replace(w=pack.w.double()), v, e, 4)
    with pytest.raises(ValueError):
        peel_decode_replay_cuda(pack, v.double(), e, 4)
    with pytest.raises(ValueError):
        peel_decode_replay_cuda(pack, v, e, -1)
    assert isinstance(pack, ReplayPack)


@pytest.mark.parametrize("fault", ["negative column", "column past the sentinel",
                                   "target at the sentinel", "descending offsets",
                                   "meta entries", "probe past R + 1"])
def test_replay_packs_are_checked_on_the_host(fault):
    _, tc = _codes("40x20")
    s = tdec.compile_peel_schedule(tc, np.random.default_rng(2).random(tc.N) < 0.3)
    host = [np.array(a) for a in (s.idx_hi, s.w_hi, s.coeff_hi, s.target, s.offsets,
                                  [[s.n_resolved, s.n_rounds, s.n_rounds + 1]])]
    ops.check_replay_host(*host, N=tc.N)
    assert s.n_rounds >= 2 and s.n_resolved >= 2
    nidx, _, _, tgt, roff, meta = host
    if fault == "negative column":
        nidx[0, 0] = -1
    elif fault == "column past the sentinel":
        nidx[-1, -1] = tc.N + 1
    elif fault == "target at the sentinel":
        tgt[0] = tc.N
    elif fault == "descending offsets":
        roff[1], roff[2] = roff[2], roff[1] - 1
    elif fault == "meta entries":
        meta[0, 0] += 1
    else:
        meta[0, 2] = s.n_rounds + 2
    with pytest.raises(ValueError, match="replay"):
        ops.check_replay_host(*host, N=tc.N)


@pytest.mark.parametrize("batch", [False, True])
def test_engine_lookup_skips_the_device_compare_of_the_same_mask(batch, monkeypatch):
    _, tc = _codes("40x20")
    vals, erased = _inputs(tc, 3, 2, [0.3, 0.08, 0.42], 21, specials=False)
    v, e = torch.from_numpy(vals), torch.from_numpy(erased)
    v, e = (v, e) if batch else (v[0], e[0])
    eng = CodedComputeEngine(tc, decode_iters=8, backend="replay", adaptive=True,
                             schedule_cache=ScheduleCache())
    decode = eng.decode_batch if batch else eng.decode
    want = CodedComputeEngine(tc, decode_iters=8, backend="replay", adaptive=True)
    want = (want.decode_batch if batch else want.decode)(v, e)

    def no_compare(*_):
        raise AssertionError("the masks were compared on the device")
    with monkeypatch.context() as m:
        m.setattr(tdec, "_sched_mask", no_compare)
        got = decode(v, e)
    _assert_bits(got.values.numpy(), want.values.numpy())
    assert torch.equal(got.erased, want.erased)
    # the lookup of another tensor, or of this one changed since, is compared
    kw = eng._schedule_kw(e, batch=batch)
    entry = (tdec.peel_decode_batch_adaptive if batch else tdec.peel_decode_adaptive)
    entry(tc, v, e.clone(), 8, backend="replay", **kw)
    flip = int(torch.nonzero(~e.reshape(-1))[0])
    e.view(-1)[flip] = True
    with pytest.raises(ValueError, match="does not match the erasure mask"):
        entry(tc, v, e, 8, backend="replay", **kw)


# ------------------------------------------------------- schedule cache

def _mask(code, seed, q=0.25):
    return np.random.default_rng(seed).random(code.N) < q


def test_cache_hit_miss_lru_and_stats():
    _, tc = _codes("40x20")
    cache = ScheduleCache(capacity=2)
    m1, m2, m3 = (_mask(tc, s) for s in (50, 51, 52))
    s1 = cache.get(tc, m1)
    assert cache.get(tc, torch.from_numpy(m1)) is s1       # hit returns same object
    cache.get(tc, m2)
    assert (cache.hits, cache.misses) == (1, 2)
    cache.get(tc, m3)                                      # evicts m1 (LRU)
    assert cache.evictions == 1 and len(cache) == 2
    s1b = cache.get(tc, m1)                                # re-solve after eviction
    assert s1b is not s1
    st = cache.stats()
    assert st["misses"] == 4 and st["size"] == 2 and st["capacity"] == 2
    assert st["hit_rate"] == pytest.approx(1 / 5)
    cache.clear()
    assert len(cache) == 0
    assert cache.stats()["misses"] == 4                    # counters are lifetime


def test_cache_batch_and_validation():
    _, tc = _codes("40x20")
    cache = ScheduleCache()
    masks = np.stack([_mask(tc, s) for s in (60, 60, 61)])
    scheds = cache.get_batch(tc, torch.from_numpy(masks))
    assert len(scheds) == 3 and scheds[0] is scheds[1]
    assert cache.misses == 2 and cache.hits == 1
    with pytest.raises(ValueError, match="must be >= 1"):
        ScheduleCache(capacity=0)
    with pytest.raises(ValueError, match="\\(B, N\\)"):
        cache.get_batch(tc, masks[0])


def test_cache_distinct_codes_do_not_collide():
    _, tc = _codes("40x20")
    other = make_regular_ldpc(20, seed=9)
    cache = ScheduleCache()
    m = _mask(tc, 70)
    assert cache.get(tc, m) is not cache.get(other, m) and cache.misses == 2


def test_cache_stats_equal_jax_on_a_stream():
    jc, tc = _codes("40x20")
    masks = [_mask(tc, 80 + i % 3) for i in range(10)]
    jcache, tcache = jsc.ScheduleCache(capacity=2), ScheduleCache(capacity=2)
    for m in masks:
        jcache.get(jc, m)
        tcache.get(tc, m)
    assert tcache.stats() == jcache.stats()


# --------------------------------------------- engine, scheme and batcher

K, SLOTS, BUDGET, N_QUERIES = 60, 4, 16, 12


@functools.cache
def _setup():
    prob = jax_problem(256, K, seed=0)
    code = jldpc.make_regular_ldpc(K, l=3, r=6, seed=0)
    return prob, code, jax_second_moment(prob.X, prob.y), convert.code_from(code)


def _schemes(adaptive=True, cache=None):
    prob, code, mom, tcode = _setup()
    js = jcs.Scheme2.build(code, mom, lr=prob.lr, decode_iters=BUDGET,
                           decode_backend="replay", adaptive=adaptive)
    ts = convert.scheme2_from_arrays(tcode, js.C, js.b, prob.lr, BUDGET, device="cpu",
                                     decode_backend="replay", adaptive=adaptive,
                                     schedule_cache=cache)
    return js, ts


def test_engine_threads_the_cache_and_equals_jax():
    _, code, _, tcode = _setup()
    tcache, jcache = ScheduleCache(), jsc.ScheduleCache()
    je = JaxEngine(code, decode_iters=8, backend="replay", schedule_cache=jcache)
    te = CodedComputeEngine(tcode, decode_iters=8, backend="replay", schedule_cache=tcache)
    vals, erased = _inputs(tcode, 4, 2, [0.3, 0.08, 0.42, 0.2], 12)
    tv, tm = torch.from_numpy(vals), torch.from_numpy(erased)
    for _ in range(2):                         # a miss, then a hit
        j, t = je.decode(vals[0], erased[0]), te.decode(tv[0], tm[0])
        _assert_bits(t.values.numpy(), j.values)
    assert (tcache.misses, tcache.hits) == (1, 1)
    budgets = np.array([8, 1, 3, 8], np.int32)
    j = je.decode_batch(jnp.asarray(vals), jnp.asarray(erased), adaptive=True,
                        budgets=jnp.asarray(budgets))
    t = te.decode_batch(tv, tm, adaptive=True, budgets=torch.from_numpy(budgets))
    _assert_bits(t.values.numpy(), j.values)
    np.testing.assert_array_equal(t.rounds_used.numpy(), np.asarray(j.rounds_used))
    assert tcache.stats() == jcache.stats()
    # without a cache every decode solves its own pattern, the same values
    bare = CodedComputeEngine(tcode, decode_iters=8, backend="replay")
    _assert_bits(bare.decode(tv[0], tm[0]).values.numpy(),
                 te.decode(tv[0], tm[0]).values.numpy())


def test_scheme_threads_the_cache():
    cache = ScheduleCache()
    js, ts = _schemes(adaptive=False, cache=cache)
    assert ts.engine.schedule_cache is cache
    _, code, _, _ = _setup()
    rng = np.random.default_rng(13)
    theta = rng.standard_normal((3, K)).astype(np.float32)
    mask = rng.random((3, code.N)) < 0.3
    mask[2] = mask[0]
    tg, tu = ts.gradient_batch(torch.from_numpy(theta), torch.from_numpy(mask))
    wg, wu = js.gradient_batch(jnp.asarray(theta), jnp.asarray(mask))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(wu))
    assert (cache.misses, cache.hits) == (2, 1)
    g1, u1 = ts.gradient(torch.from_numpy(theta[1]), torch.from_numpy(mask[1]))
    assert cache.hits == 2 and int(u1) == int(tu[1])
    for b in range(3):
        _assert_gradients_agree(tg[b].numpy(), np.asarray(wg)[b], theta[b], mask[b])


def _g64(theta, mask):
    """The port's gradient of one query from its own f32 worker products
    (as the batcher forms them), decoded in float64 under the "lo" rule."""
    _, ts = _schemes()
    th, m = torch.from_numpy(theta), torch.from_numpy(mask)
    z = ts.engine.erase(((th[None] @ ts.C.T)[0]).double(), m)
    idx, coeff = (torch.from_numpy(a) for a in (ts.code.check_idx, ts.code.check_coeff))
    v, e = ref.decode_table_ref(idx, coeff.double(), z[:, None], m, BUDGET)
    c_hat = torch.where(e[:K], 0.0, v[:K, 0])
    return (c_hat - torch.where(e[:K], 0.0, ts.b.double())).numpy()


def _assert_gradients_agree(got, want, theta, mask):
    _, _, mom, _ = _setup()
    zero = want == 0.0
    np.testing.assert_array_equal(got[zero], 0.0)
    if zero.all():
        return
    exact = np.asarray(mom.M, np.float64) @ theta.astype(np.float64) - np.asarray(mom.b)
    anchor = max(float(np.abs(want - exact)[~zero].max()),
                 float(np.abs(_g64(theta, mask) - exact)[~zero].max()))
    diff = float(np.abs(got - want).max())
    assert diff <= 1e-4 * float(np.abs(want).max()) + 4 * anchor, (diff, anchor)


def _stream():
    """12 queries cycling over 4 straggler patterns (one heavy at q = 0.5,
    past the (3, 6) threshold, and three light at q = 0.08), each with its
    own θ."""
    _, code, _, _ = _setup()
    rng = np.random.default_rng(0)
    pats = rng.random((4, code.N)) < np.array([0.5, 0.08, 0.08, 0.08])[:, None]
    thetas = rng.standard_normal((N_QUERIES, K)).astype(np.float32)
    return [(i, thetas[i], pats[i % 4]) for i in range(N_QUERIES)]


@pytest.mark.parametrize("own_cache", [False, True])
def test_replay_batcher_equals_jax(own_cache):
    cache = ScheduleCache() if own_cache else None
    js, ts = _schemes(cache=cache)
    jb = jcq.CodedQueryBatcher(js, n_slots=SLOTS, rounds_per_launch=BUDGET)
    tb = CodedQueryBatcher(ts, n_slots=SLOTS, rounds_per_launch=BUDGET)
    assert (tb.schedule_cache is cache) if own_cache else tb.schedule_cache is not None
    for qid, theta, mask in _stream():
        jb.submit(jcq.CodedQuery(qid, theta, mask))
        tb.submit(CodedQuery(qid, theta, mask))
    want, got = jb.run(), tb.run()
    assert tb.launches == jb.launches
    assert [q.qid for q in got] == [q.qid for q in want]
    fields = ("rounds", "launches", "admitted_launch", "finished_launch",
              "unresolved", "done")
    for g, w in zip(got, want):
        assert {f: getattr(g, f) for f in fields} == {f: getattr(w, f) for f in fields}
        _assert_gradients_agree(g.gradient, np.asarray(w.gradient), g.theta,
                                g.straggler_mask)
    assert sum(q.unresolved for q in got) > 0              # the decode had work
    assert tb.schedule_cache.stats() == jb.schedule_cache.stats()
    assert tb.schedule_cache.hits > 0


def test_replay_batcher_rejects_a_chunked_budget():
    _, ts = _schemes()
    with pytest.raises(ValueError, match="rounds_per_launch"):
        CodedQueryBatcher(ts, n_slots=SLOTS, rounds_per_launch=BUDGET - 1)
    # lockstep waves run the whole budget in one launch: no chunk to check
    assert CodedQueryBatcher(ts, n_slots=SLOTS, mode="lockstep").schedule_cache is None


# ------------------------------------------------ the table decode at any N

def _padded_code():
    """The (40, 20) code with a tenth of H's entries dropped (each row
    keeps at least two): rows of unequal weight, so the table pads them
    with the sentinel N."""
    jc, _ = _codes("40x20")
    H = np.array(jc.H)
    rng = np.random.default_rng(17)
    for i, j in zip(*np.nonzero(H)):
        if rng.random() < 0.1 and np.count_nonzero(H[i]) > 2:
            H[i, j] = 0.0
    code = convert.code_from_arrays(H, jc.G, jc.N, jc.K, jc.l, jc.r)
    assert (code.check_idx == code.N).any()
    return code


@pytest.mark.parametrize("contract", ["fixed", "batch", "adaptive", "batch_adaptive"])
def test_table_plain_equals_dense_plain(contract):
    code = _padded_code()
    vals, erased = _inputs(code, 6, 3, [0.0, 0.1, 0.25, 0.4, 0.5, 0.3], 21)
    v, e = torch.from_numpy(vals), torch.from_numpy(erased)
    idx, coeff = torch.from_numpy(code.check_idx), torch.from_numpy(code.check_coeff)
    H = dense_h(idx, coeff, code.N)
    budgets = torch.tensor([0, 1, 3, 8, 40, 2], dtype=torch.int32)
    got, want = {
        "fixed": lambda: (ref.decode_table_ref(idx, coeff, v[1], e[1], 6),
                          ref.decode_fused_ref(H, v[1], e[1], 6)),
        "batch": lambda: (ref.decode_table_batch_ref(idx, coeff, v, e, 5),
                          ref.decode_fused_batch_ref(H, v, e, 5)),
        "adaptive": lambda: (ref.decode_table_adaptive_ref(idx, coeff, v[3], e[3], 40),
                             ref.decode_fused_adaptive_ref(H, v[3], e[3], 40)),
        "batch_adaptive": lambda: (
            ref.decode_table_batch_adaptive_ref(idx, coeff, v, e, budgets),
            ref.decode_fused_batch_adaptive_ref(H, v, e, budgets)),
    }[contract]()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b)
    # and the table wrappers run it on CPU tensors
    tables = tdec.code_tables(code, "cpu")
    if contract == "batch_adaptive":
        out = ops.peel_decode_batch_adaptive_cuda(tables, v, e, budgets)
        assert all(torch.equal(x, y) for x, y in zip(out[1:], want[1:]))


def test_code_tables_check_the_column_order():
    _, tc = _codes("40x20")
    tdec._check_ascending(tc.check_idx, tc.N)
    bad = tc.check_idx.copy()
    bad[3, [0, 1]] = bad[3, [1, 0]]
    with pytest.raises(ValueError, match="ascending"):
        tdec._check_ascending(bad, tc.N)
    gap = tc.check_idx.copy()
    gap[2, 1] = tc.N                        # padding before a real column
    with pytest.raises(ValueError, match="ascending"):
        tdec._check_ascending(gap, tc.N)
    fake = types.SimpleNamespace(check_idx=bad, check_coeff=tc.check_coeff, N=tc.N,
                                 device_cache={})
    with pytest.raises(ValueError, match="ascending"):
        tdec.code_tables(fake, "cpu")
    tdec._check_ascending(_padded_code().check_idx, tc.N)


@pytest.mark.parametrize("values", ["pm1", "gaussian"])
def test_table_plain_equals_jax_sparse_at_4096(values):
    jc = jldpc.make_parity_only_ldpc(2048, seed=4, values=values)
    tc = convert.code_from(jc)
    assert tc.N == 4096
    vals, erased = _inputs(tc, 3, 1, [0.25, 0.4, 0.45], 31, specials=False)
    budgets = np.array([32, 5, 32], np.int32)
    j = jdec.peel_decode_batch_adaptive(jc, vals, erased, backend="sparse",
                                        budgets=jnp.asarray(budgets))
    t = tdec.peel_decode_batch_adaptive(tc, torch.from_numpy(vals),
                                        torch.from_numpy(erased), backend="cuda",
                                        budgets=torch.from_numpy(budgets))
    np.testing.assert_array_equal(t.erased.numpy(), np.asarray(j.erased))
    np.testing.assert_array_equal(t.rounds_used.numpy(), np.asarray(j.rounds_used))
    got, want = t.values.numpy(), np.asarray(j.values)
    if values == "pm1":          # integer payloads, ±1 weights: every step exact
        np.testing.assert_array_equal(got, want)
        return
    # the anchor: the same decode of the same f32 inputs in float64
    idx, coeff = torch.from_numpy(tc.check_idx), torch.from_numpy(tc.check_coeff)
    d64 = ref.decode_table_batch_adaptive_ref(
        idx, coeff.double(), torch.from_numpy(vals).double(), torch.from_numpy(erased),
        torch.from_numpy(budgets))[0].numpy()
    resolved = erased & ~np.asarray(j.erased)
    assert resolved.any()
    for b in range(3):
        r = resolved[b]
        anchor = float(np.abs(want[b][r] - d64[b][r]).max())
        diff = float(np.abs(got[b] - want[b]).max())
        assert diff <= 1e-4 * float(np.abs(d64[b][r]).max()) + 4 * anchor, (b, diff, anchor)
