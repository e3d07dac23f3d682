"""The seeded decode's inverse map and per-check counts, on the CPU.

The card's seeded decode (``csrc/seeded_decode.cu``) keeps one count of
erased neighbours per check row and reaches a coordinate's rows through
the layers' inverse permutations.  Their plain versions are held here:

* ``ref.seeded_col_rows`` (column -> its row and slot in every layer)
  against the forward rows of the JAX package's ``seeded_check_rows``:
  every row it names holds the column, in the slot the draw order puts it
  at, and over all columns it rebuilds the JAX table exactly.  Codes of
  ``make_seeded_ldpc`` at N = 512 and 2048 (the (4, 8) ensemble), of row
  weight 24, 40 and 80 with 20 and 8 layers, a 20-layer row-weight-8
  structure, and the structure-only ``SeededLDPC`` at N = 262,144 on a
  sampled set of columns.
* ``ref.seeded_counts`` (the counts built from the inverse map) equal to
  ``H·e`` at every round of the plain decode's trajectory, slots with a
  round budget of 0 beside busy ones, at erasure fractions 0.25 and 0.45;
  and the coordinates each plain round resolves are exactly the erased
  ones with a row of count 1 in some layer, the rule by which the kernel
  decrements its counts.
"""
import numpy as np
import pytest
import torch

from repro.core.ldpc import SeededLDPC as JaxSeededLDPC
from repro.core.ldpc import make_seeded_ldpc as jax_make_seeded_ldpc
from repro.core.ldpc import seeded_check_rows, seeded_structure
from repro.core.ldpc import seeded_structure_of as jax_structure_of
from repro_torch.core import decoder
from repro_torch.core.ldpc import make_seeded_ldpc
from repro_torch.kernels.ldpc_peel import ref

# name -> the JAX package's structure (the port's copy is held to it
# field by field in tests/test_torch_seeded.py)
_STRUCTURES = {
    "ldpc_N512": lambda: jax_structure_of(jax_make_seeded_ldpc(256, seed=0)),
    "ldpc_N2048": lambda: jax_structure_of(jax_make_seeded_ldpc(1024, seed=3)),
    "l20_r24": lambda: jax_structure_of(jax_make_seeded_ldpc(64, l=20, r=24, seed=1)),
    "l20_r40": lambda: jax_structure_of(jax_make_seeded_ldpc(160, l=20, r=40, seed=1)),
    "l8_r80": lambda: jax_structure_of(jax_make_seeded_ldpc(720, l=8, r=80, seed=1)),
    "l20_r8": lambda: seeded_structure(20 * 2048 // 8, 2048, 8, 7),
}


@pytest.mark.parametrize("name", list(_STRUCTURES))
def test_inverse_map_matches_the_forward_rows(name):
    st = _STRUCTURES[name]()
    rows, slots = ref.seeded_col_rows(st, torch.arange(st.cols))
    assert rows.shape == slots.shape == (st.cols, st.layers)
    # the forward table, rebuilt from the inverse map, is the JAX table
    table = torch.full((st.rows, st.row_weight), -1, dtype=torch.int64)
    table[rows.reshape(-1), slots.reshape(-1)] = torch.arange(st.cols).repeat_interleave(st.layers)
    assert bool((table >= 0).all())                   # every (row, slot) reached once
    jidx, _ = seeded_check_rows(st, 0, st.rows)
    assert np.array_equal(np.sort(table.numpy(), axis=1), jidx)
    # slots in the draw order (the port's seeded_rows, itself held to JAX)
    drawn, _ = ref.seeded_rows(st, 0, st.rows)
    assert torch.equal(drawn, table)
    # layer t's row lies in layer t
    t = torch.arange(st.layers)
    assert bool(((rows // st.rows_per_layer) == t).all())


def test_inverse_map_of_the_structure_only_code_at_262144():
    code = JaxSeededLDPC(N=262144, K=131072, l=4, r=8, seed=0)
    st = code.structure
    cols = torch.from_numpy(np.random.default_rng(9).choice(st.cols, 256, replace=False))
    cols = torch.cat([cols, torch.tensor([0, st.cols - 1])])
    rows, slots = ref.seeded_col_rows(st, cols)
    for j, rr, ss in zip(cols.tolist(), rows.tolist(), slots.tolist()):
        for row, slot in zip(rr, ss):
            jidx, _ = seeded_check_rows(st, row, row + 1)
            assert j in jidx[0]
            drawn, _ = ref.seeded_rows(st, row, row + 1)
            assert int(drawn[0, slot]) == j


def _trajectory(st, values, erased, budgets):
    """The plain decode's per-slot trajectory under ``budgets`` (the
    adaptive contract's rules), yielding each round's start state."""
    round_fn = ref._seeded_round(st, values.device)
    vals, e = values.clone(), erased.clone()
    d = torch.zeros(e.shape[0], dtype=torch.int32)
    active = (budgets > 0) & e.any(dim=-1)
    while True:
        yield e, active
        if not bool(active.any()):
            return
        v2, e2 = round_fn(vals, e)
        changed = (e2 != e).any(dim=-1)
        vals = torch.where(active[:, None, None], v2, vals)
        e = torch.where(active[:, None], e2, e)
        d = d + active.to(torch.int32)
        active = active & (d < budgets) & changed & e.any(dim=-1)


@pytest.mark.parametrize("f", [0.25, 0.45])
@pytest.mark.parametrize("K", [256, 1024])
def test_counts_from_the_inverse_are_h_e_along_the_trajectory(K, f):
    code = make_seeded_ldpc(K, seed=0)
    st = decoder.seeded_spec(code)
    H = torch.from_numpy(np.asarray(code.H) != 0).to(torch.int64)
    rng = np.random.default_rng(K + int(100 * f))
    B = 8
    erased = torch.from_numpy(rng.random((B, code.N)) < f)
    values = torch.from_numpy(rng.standard_normal((B, code.N, 2)).astype(np.float32))
    budgets = torch.tensor([0, 1, 3, 8, 0, code.N, 2, code.N], dtype=torch.int32)
    prev = None
    rounds = 0
    for e, active in _trajectory(st, values, erased, budgets):
        cnt = ref.seeded_counts(st, e)
        assert torch.equal(cnt, e.to(torch.int64) @ H.T)
        if prev is not None:
            # what a round resolved: the erased coordinates with a row of
            # count 1 at its start (the kernel's decrements), on active slots
            pe, pcnt, pactive = prev
            rows, _ = ref.seeded_col_rows(st, torch.arange(code.N))
            solvable = (pcnt[:, rows] == 1).any(dim=-1) & pe
            assert torch.equal(pe & ~e, solvable & pactive[:, None])
        prev = (e, cnt, active)
        rounds += 1
    assert torch.equal(erased[[0, 4]], prev[0][[0, 4]])       # budget 0: untouched
    assert rounds > 3 and bool((erased & ~prev[0]).any())
