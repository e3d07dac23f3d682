"""The port's coded-query serving path against the JAX package's.

Covers, bottom up: Scheme 2's batched epilogue and the engine's batched
stages (per-slot counts on a batch), the batched and adaptive engine
decodes, ``Scheme2.gradient_batch`` and ``Scheme2(adaptive=True)``, the
``SlotPool`` copy, and ``CodedQueryBatcher`` in both modes over one query
stream.  Both packages compute from the very same code, encoded moment,
query parameters and straggler masks (numpy, from a seed; the port's
objects are built through ``repro_torch.convert`` from the JAX side's
arrays).

Erasure trajectories and everything that follows from them must match
exactly: unresolved counts, round counts, and each query's serving
accounting (``rounds``, ``launches``, ``admitted_launch``,
``finished_launch``, completion order).  Gradients: on the zero-filled
(unresolved) coordinates both are 0; on the coordinates the reference
resolved::

    |g_port − g_ref| ≤ 1e-4·max|g_ref| + 4·max(|g_ref − g_exact|, |g64 − g_exact|)

with ``g_exact = Mθ − b`` in float64 and ``g64`` the port's gradient of
the same query from its own f32 worker products ``Cθ``, decoded in float64
under the same tie-break.  The first term is f32 summation order.  The second admits the
port's own rounding carried along peeling chains, anchored to how far the
chains of this very query amplify rounding: the reference's own error, and
the error that the rounding of the port's f32 worker products alone
leaves after an exact decode (which dominates the port's error; why one
measure is not enough: tests/test_torch_decode_batch.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_step as jcs
from repro.core import engine as jeng
from repro.core import ldpc as jldpc
from repro.core.encoding import second_moment as jax_second_moment
from repro.core.straggler import FixedCountStragglers as JaxFixedCount
from repro.data import make_linear_problem as jax_problem
from repro.serving import coded_queries as jcq
from repro.serving import slot_lifecycle as jsl
from repro_torch import convert
from repro_torch.core import decoder as tdec
from repro_torch.core import engine as teng
from repro_torch.core.decoder import DecodeResult
from repro_torch.kernels.ldpc_peel import ref
from repro_torch.serving import CodedQuery, CodedQueryBatcher, SlotPool

# examples/serve_coded_continuous.py: K = 60, 12 queries, every 4th heavy
K, N_QUERIES, HEAVY_EVERY, SLOTS, CHUNK, BUDGET = 60, 12, 4, 4, 2, 16
BACKENDS = [("pallas", "cuda"), ("dense", "dense")]


@functools.cache
def _setup():
    prob = jax_problem(256, K, seed=0)
    code = jldpc.make_regular_ldpc(K, l=3, r=6, seed=0)
    mom = jax_second_moment(prob.X, prob.y)
    return prob, code, mom, convert.code_from(code)


def _jax_scheme(backend, adaptive, decode_iters=BUDGET):
    prob, code, mom, _ = _setup()
    return jcs.Scheme2.build(code, mom, lr=prob.lr, decode_iters=decode_iters,
                             decode_backend=backend, adaptive=adaptive)


def _port_scheme(backend, adaptive, decode_iters=BUDGET):
    prob, _, mom, tcode = _setup()
    js = _jax_scheme("dense", False)
    return convert.scheme2_from_arrays(tcode, js.C, js.b, prob.lr, decode_iters,
                                       device="cpu", decode_backend=backend,
                                       adaptive=adaptive)


def _stream():
    """(qid, θ, mask, priority): light queries at q = 0.08, every 4th heavy
    at q = 0.42 (near the (3, 6) threshold); priorities 2, 1 and 0.5."""
    _, code, _, _ = _setup()
    rng = np.random.default_rng(0)
    out = []
    for i in range(N_QUERIES):
        q = 0.42 if i % HEAVY_EVERY == 0 else 0.08
        out.append((i, rng.standard_normal(K).astype(np.float32),
                    rng.random(code.N) < q, (2.0, 1.0, 0.5)[i % 3]))
    return out


def _g_exact(theta):
    _, _, mom, _ = _setup()
    M, b = np.asarray(mom.M, np.float64), np.asarray(mom.b, np.float64)
    return M @ np.asarray(theta, np.float64) - b


@functools.cache
def _scheme64():
    ts = _port_scheme("dense", False)
    return dataclasses.replace(ts, C=ts.C.double(), b=ts.b.double())


def _g64(theta, mask, decode_iters, rule, batched):
    """The port's gradient from its own f32 worker products (as its batched
    or single path forms them), decoded in float64 with the "lo" (plain
    version on a float64 H) or "hi" (dense) tie-break."""
    s64 = _scheme64()
    C, th = _port_scheme("dense", False).C, torch.from_numpy(np.asarray(theta))
    m = torch.from_numpy(np.asarray(mask))
    z = s64.engine.erase(((th[None] @ C.T)[0] if batched else C @ th).double(), m)
    if rule == "lo":
        H = torch.from_numpy(s64.code.H).double()
        v, e = ref.decode_fused_ref(H, z[:, None], m, decode_iters)
        dec = DecodeResult(v[:, 0], e, decode_iters)
    else:
        dec = tdec.peel_decode(s64.code, z, m, decode_iters, backend="dense")
    return s64.finish_gradient(*s64.engine.systematic(dec))[0].numpy()


def _assert_gradients_agree(got, want, theta, mask, decode_iters=BUDGET, *,
                            rule, batched=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    zero = want == 0.0                       # the zero-filled coordinates
    np.testing.assert_array_equal(got[zero], 0.0)
    if zero.all():
        return
    exact = _g_exact(theta)
    g64 = _g64(theta, mask, decode_iters, rule, batched)
    anchor = max(float(np.abs(want - exact)[~zero].max()),
                 float(np.abs(g64 - exact)[~zero].max()))
    diff = float(np.abs(got - want).max())
    assert diff <= 1e-4 * float(np.abs(want).max()) + 4 * anchor, (diff, anchor)


def _rule(torch_backend):
    return "lo" if torch_backend == "cuda" else "hi"


# ------------------------------------------- batched epilogue: per slot

def test_finish_gradient_counts_each_slot_of_a_batch():
    js = _jax_scheme("dense", False)
    ts = _port_scheme("dense", False)
    rng = np.random.default_rng(3)
    c_hat = rng.standard_normal((5, K)).astype(np.float32)
    unresolved = rng.random((5, K)) < np.array([0.0, 0.1, 0.3, 0.5, 1.0])[:, None]
    wg, wn = js.finish_gradient(jnp.asarray(c_hat), jnp.asarray(unresolved))
    tg, tn = ts.finish_gradient(torch.from_numpy(c_hat), torch.from_numpy(unresolved))
    assert tuple(tn.shape) == (5,)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(wn))
    np.testing.assert_array_equal(tn.numpy(), unresolved.sum(axis=1))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(wg))     # selects, subtracts
    # one pattern still gives one count
    g1, n1 = ts.finish_gradient(torch.from_numpy(c_hat[2]),
                                torch.from_numpy(unresolved[2]))
    assert n1.ndim == 0 and int(n1) == unresolved[2].sum()
    np.testing.assert_array_equal(g1.numpy(), tg[2].numpy())


@pytest.mark.parametrize("V", [None, 3])
def test_systematic_slices_the_coordinate_axis_of_a_batch(V):
    _, code, _, tcode = _setup()
    rng = np.random.default_rng(4)
    shape = (6, code.N) if V is None else (6, code.N, V)
    values = rng.standard_normal(shape).astype(np.float32)
    erased = rng.random((6, code.N)) < np.linspace(0, 0.6, 6)[:, None]
    jv, ju = jeng.CodedComputeEngine(code).systematic(
        jeng.DecodeResult(jnp.asarray(values), jnp.asarray(erased), jnp.int32(3)))
    tv, tu = teng.CodedComputeEngine(tcode).systematic(
        DecodeResult(torch.from_numpy(values), torch.from_numpy(erased), 3))
    assert tuple(tv.shape) == (6, K, *(() if V is None else (V,)))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tu.sum(dim=1).numpy(), erased[:, :K].sum(axis=1))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------ engine batch stages

@pytest.mark.parametrize("jax_backend,torch_backend", BACKENDS)
@pytest.mark.parametrize("adaptive,budgets", [(False, None), (True, None),
                                              (True, [0, 1, 3, 16, 2, 120])])
def test_engine_recover_batch_matches_jax(jax_backend, torch_backend, adaptive,
                                          budgets):
    _, code, _, tcode = _setup()
    rng = np.random.default_rng(5)
    msg = rng.standard_normal((6, K, 2)).astype(np.float32)
    mask = rng.random((6, code.N)) < np.array([0.0, 0.08, 0.3, 0.42, 0.42, 0.2])[:, None]
    je = jeng.CodedComputeEngine(code, decode_iters=BUDGET, backend=jax_backend)
    te = teng.CodedComputeEngine(tcode, decode_iters=BUDGET, backend=torch_backend)
    symbols = np.array(jax.vmap(je.encode)(jnp.asarray(msg)))
    kw = {"adaptive": adaptive}
    jdec_ = je.decode_batch(je.erase(jnp.asarray(symbols), jnp.asarray(mask)),
                            jnp.asarray(mask), **kw,
                            budgets=None if budgets is None else jnp.asarray(budgets))
    tdec_ = te.decode_batch(te.erase(torch.from_numpy(symbols), torch.from_numpy(mask)),
                            torch.from_numpy(mask), **kw,
                            budgets=None if budgets is None
                            else torch.tensor(budgets, dtype=torch.int32))
    np.testing.assert_array_equal(tdec_.erased.numpy(), np.asarray(jdec_.erased))
    if adaptive:
        np.testing.assert_array_equal(tdec_.rounds_used.numpy(),
                                      np.asarray(jdec_.rounds_used))
    else:
        assert tdec_.rounds_used == BUDGET
    wv, wu = je.recover_batch(jnp.asarray(symbols), jnp.asarray(mask), **kw,
                              budgets=None if budgets is None else jnp.asarray(budgets))
    tv, tu = te.recover_batch(torch.from_numpy(symbols), torch.from_numpy(mask),
                              **kw, budgets=budgets)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(wu))
    wv, tv = np.asarray(wv), tv.numpy()
    resolved = ~np.asarray(wu)
    for b in range(6):
        truth = msg[b][resolved[b]]
        if truth.size == 0:
            continue
        anchor = float(np.abs(wv[b][resolved[b]] - truth).max())
        assert (float(np.abs(tv[b] - wv[b]).max())
                <= 1e-4 * float(np.abs(msg[b]).max()) + 16 * anchor)


def test_engine_budgets_need_the_adaptive_decode():
    _, _, _, tcode = _setup()
    te = teng.CodedComputeEngine(tcode, decode_iters=4, backend="dense")
    v = torch.zeros((2, tcode.N))
    e = torch.zeros((2, tcode.N), dtype=torch.bool)
    with pytest.raises(ValueError, match="budgets= requires"):
        te.decode_batch(v, e, budgets=[1, 2])
    res = dataclasses.replace(te, adaptive=True).decode_batch(v, e, budgets=[1, 2])
    assert res.rounds_used.tolist() == [0, 0]             # nothing erased


@pytest.mark.parametrize("backend", ["sparse", "pallas", "pallas_tiled"])
def test_backends_not_ported_stay_unknown(backend):
    _, _, _, tcode = _setup()
    with pytest.raises(ValueError, match="unknown decode backend"):
        tdec.resolve_backend(backend)
    with pytest.raises(ValueError, match="unknown decode backend"):
        teng.CodedComputeEngine(tcode, backend=backend)


# --------------------------------------------------- Scheme 2, batched

@pytest.mark.parametrize("jax_backend,torch_backend", BACKENDS)
@pytest.mark.parametrize("adaptive", [False, True])
def test_gradient_batch_matches_jax(jax_backend, torch_backend, adaptive):
    _, code, _, _ = _setup()
    stream = _stream()
    theta = np.stack([s[1] for s in stream])
    mask = np.stack([s[2] for s in stream])
    # a budget of 3 rounds leaves the heavy queries partly unresolved
    wg, wu = _jax_scheme(jax_backend, adaptive, 3).gradient_batch(
        jnp.asarray(theta), jnp.asarray(mask))
    tg, tu = _port_scheme(torch_backend, adaptive, 3).gradient_batch(
        torch.from_numpy(theta), torch.from_numpy(mask))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(wu))
    assert np.asarray(wu).sum() > 0                       # the decode had work
    for b in range(N_QUERIES):
        _assert_gradients_agree(tg[b].numpy(), np.asarray(wg)[b], theta[b],
                                mask[b], 3, rule=_rule(torch_backend))


@pytest.mark.parametrize("jax_backend,torch_backend", BACKENDS)
def test_adaptive_scheme_steps_match_jax(jax_backend, torch_backend):
    # 10 steps of the adaptive scheme on the masks JAX's run_pgd would draw.
    # At each step of the JAX run both packages take the gradient at the
    # same θ: the unresolved count must match exactly, the gradient within
    # the anchored bound, and one step of the port lands where JAX's does
    # up to lr times that bound.
    prob, code, _, _ = _setup()
    keys = jax.random.split(jax.random.PRNGKey(7), 10)
    masks = np.array(jax.vmap(lambda k: JaxFixedCount(40).sample(k, code.N))(keys))
    js = _jax_scheme(jax_backend, True, decode_iters=6)
    ts = _port_scheme(torch_backend, True, decode_iters=6)
    assert ts.engine.adaptive
    theta = np.zeros(K, np.float32)
    total = 0
    for m in masks:
        wg, wu = js.gradient(jnp.asarray(theta), jnp.asarray(m))
        tg, tu = ts.gradient(torch.from_numpy(theta), torch.from_numpy(m))
        assert int(tu) == int(wu)
        total += int(wu)
        _assert_gradients_agree(tg.numpy(), wg, theta, m, 6,
                                rule=_rule(torch_backend), batched=False)
        wt, _ = js.step(jnp.asarray(theta), jnp.asarray(m))
        tt, _ = ts.step(torch.from_numpy(theta), torch.from_numpy(m))
        step_diff = float(np.abs(tt.numpy() - np.asarray(wt)).max())
        assert step_diff <= 1e-6 + prob.lr * float(np.abs(tg.numpy() - np.asarray(wg)).max()) * 1.01
        theta = np.array(wt)
    assert total > 0


# ------------------------------------------------------------- SlotPool

def test_slot_pool_matches_jax_on_a_script():
    pools = (jsl.SlotPool(3, budget=8, rounds_per_launch=3),
             SlotPool(3, budget=8, rounds_per_launch=3))
    script = [
        ("admit", 0, "a", None), ("admit", 1, "b", 6), ("grant",),
        ("account", [3, 2, 0], [5, 0, 9]),            # b converged (0 left)
        ("admit", 1, "c", 1), ("admit", 2, "d", None), ("grant",),
        ("account", [3, 1, 3], [4, 2, 7]),            # a keeps going
        ("grant",),
        ("account", [2, 1, 1], [1, 1, 1]),            # a spent 8; d stopped early
        ("grant",), ("account", [0, 1, 0], [0, 1, 0]),
    ]
    for step in script:
        outs = []
        for pool in pools:
            if step[0] == "admit":
                _, s, owner, chunk = step
                pool.admit(s, owner, chunk=chunk)
                outs.append(None)
            elif step[0] == "grant":
                outs.append(pool.launch_budgets().tolist())
            else:
                outs.append(pool.account(np.array(step[1]), np.array(step[2])))
        assert outs[0] == outs[1], step
        jp, tp = pools
        assert jp.occupied.tolist() == tp.occupied.tolist()
        assert jp.free_slots() == tp.free_slots()
        assert [jp.rounds_spent(s) for s in range(3)] == \
            [tp.rounds_spent(s) for s in range(3)]
    for pool_cls in (jsl.SlotPool, SlotPool):
        with pytest.raises(ValueError):
            pool_cls(0, budget=4)
        with pytest.raises(ValueError):
            pool_cls(2, budget=4, rounds_per_launch=0)
        pool = pool_cls(1, budget=4)
        pool.admit(0, "x")
        with pytest.raises(ValueError, match="occupied"):
            pool.admit(0, "y")


# ------------------------------------------------------- the batcher

@functools.cache
def _jax_serve(mode, adaptive, backend):
    scheme = _jax_scheme(backend, adaptive)
    kw = {"rounds_per_launch": CHUNK} if mode == "continuous" else {}
    bat = jcq.CodedQueryBatcher(scheme, n_slots=SLOTS, mode=mode, **kw)
    for qid, theta, mask, prio in _stream():
        bat.submit(jcq.CodedQuery(qid, theta, mask, priority=prio))
    return bat.run(), bat.launches


def _port_serve(mode, adaptive, backend):
    kw = {"rounds_per_launch": CHUNK} if mode == "continuous" else {}
    bat = CodedQueryBatcher(_port_scheme(backend, adaptive), n_slots=SLOTS,
                            mode=mode, **kw)
    for qid, theta, mask, prio in _stream():
        bat.submit(CodedQuery(qid, theta, mask, priority=prio))
    return bat.run(), bat.launches


@pytest.mark.parametrize("jax_backend,torch_backend", BACKENDS)
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("mode", ["continuous", "lockstep"])
def test_batcher_matches_jax(mode, adaptive, jax_backend, torch_backend):
    want, want_launches = _jax_serve(mode, adaptive, jax_backend)
    got, got_launches = _port_serve(mode, adaptive, torch_backend)
    assert got_launches == want_launches
    assert [q.qid for q in got] == [q.qid for q in want]   # completion order
    fields = ("rounds", "launches", "admitted_launch", "finished_launch",
              "unresolved", "done")
    for g, w in zip(got, want):
        assert {f: getattr(g, f) for f in fields} == \
            {f: getattr(w, f) for f in fields}, g.qid
        _assert_gradients_agree(g.gradient, w.gradient, g.theta,
                                g.straggler_mask, rule=_rule(torch_backend))
    assert sum(q.unresolved for q in got) > 0             # the decode had work
    if mode == "continuous":
        assert got_launches > -(-N_QUERIES // SLOTS)      # slots refilled
        heavy = [q for q in got if q.qid % HEAVY_EVERY == 0]
        assert max(q.launches for q in heavy) > 1         # across launches


def test_continuous_stats_match_the_single_query_decode():
    # Per query, the rounds the batcher charged across its chunked launches
    # equal the rounds of one adaptive decode of that query, probe round
    # included; its unresolved count and gradient equal Scheme2.gradient's.
    # Except at a chunk of one round (priority 0.5 here): there the probe
    # round is the whole grant, so the retire rule cannot see the fixpoint
    # and a stuck query probes until its budget is spent.  The JAX
    # package's SlotPool does the same (test_batcher_matches_jax).
    ts = _port_scheme("cuda", True)
    got, _ = _port_serve("continuous", True, "cuda")
    stuck_at_chunk_one = 0
    for q in got:
        g, u = ts.gradient(torch.from_numpy(q.theta),
                           torch.from_numpy(q.straggler_mask))
        z = ts.C @ torch.from_numpy(q.theta)
        mask = torch.from_numpy(q.straggler_mask)
        one = tdec.peel_decode_adaptive(ts.code, ts.engine.erase(z, mask), mask,
                                        BUDGET, backend="cuda")
        if round(CHUNK * q.priority) <= 1 and bool(one.erased.any()):
            assert q.rounds == BUDGET, q.qid
            stuck_at_chunk_one += 1
        else:
            assert q.rounds == int(one.rounds_used), q.qid
        assert q.unresolved == int(u)
        _assert_gradients_agree(q.gradient, g.numpy(), q.theta,
                                q.straggler_mask, rule="lo", batched=False)
    assert stuck_at_chunk_one > 0


def test_inert_slots_pass_through():
    # Fewer queries than slots: the idle slots get budget 0 and change
    # nothing; each query still matches its single-query gradient.
    ts = _port_scheme("cuda", False)
    bat = CodedQueryBatcher(ts, n_slots=8, rounds_per_launch=4)
    stream = _stream()[:3]
    for qid, theta, mask, _ in stream:
        bat.submit(CodedQuery(qid, theta, mask))
    done = bat.run()
    assert len(done) == 3
    assert not bat._erased[3:].any() and not bat._vals[3:].any()
    for q in done:
        g, u = ts.gradient(torch.from_numpy(q.theta),
                           torch.from_numpy(q.straggler_mask))
        assert q.unresolved == int(u)


def test_batcher_validates():
    ts = _port_scheme("dense", False)
    with pytest.raises(ValueError, match="unknown mode"):
        CodedQueryBatcher(ts, mode="waves")
    with pytest.raises(ValueError, match="rounds_per_launch"):
        CodedQueryBatcher(ts, rounds_per_launch=0)
    with pytest.raises(TypeError, match="gradient_batch"):
        CodedQueryBatcher(object())
    bat = CodedQueryBatcher(ts, n_slots=2)
    with pytest.raises(ValueError, match="theta"):
        bat.submit(CodedQuery(0, np.zeros(K + 1, np.float32),
                              np.zeros(2 * K, bool)))
    with pytest.raises(ValueError, match="straggler_mask"):
        bat.submit(CodedQuery(0, np.zeros(K, np.float32), np.zeros(K, bool)))
