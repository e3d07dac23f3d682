"""The table decode's column table and per-check counts, on the CPU.

The card's table decode (``csrc/peel_decode.cu``) keeps one count of erased
neighbours per check row and reaches a coordinate's rows through the
table's column table.  Their plain versions are held here:

* ``ref.column_table`` (column -> its check rows, ascending, built from
  ``check_idx`` with the sentinel padding skipped) against the nonzeros of
  each column of the JAX package's H: the (40, 20) code and the (3, 6) code
  at K = 1024 of ``make_regular_ldpc``, ``make_parity_only_ldpc(4096)``
  and ``make_seeded_ldgm(512, 256, row_weight=8)`` (parity columns of
  degree 1 beside systematic ones of degree 4); and a table with padding
  slots and rows of different weights.
* ``ref.column_counts`` (the counts built, and then lowered, through the
  column table alone) equal to ``H·e`` at every round of the plain
  decode's trajectory, and ``ref.column_xors`` (each row's XOR of its
  erased columns, kept the same way) naming the erased column of every
  row of one erased neighbour, at erasure fractions 0, 0.25 and 0.45, slots with a
  round budget of 0 beside busy ones; and the coordinates each plain round
  resolves are exactly the erased ones with a row of count 1, the rule by
  which the kernel lowers its counts.
* The wrapper's column table is never stale against the ``check_idx`` it
  is given (an in-place change, another ``N``, a ``CodeTables._replace``),
  and the dispatch by shape puts the state, then the values, then the
  tables on chip as far as they fit (all three at N = 2048, the state and
  values at Path A's N = 24,576, the state at phase 15's N = 49,152) and
  the state in device memory past a block's shared memory.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import ldpc as jldpc
from repro_torch.convert import code_from
from repro_torch.core import decoder
from repro_torch.kernels.ldpc_peel import CodeTables, ops, ref

_CODES = {
    "regular_K20": lambda: jldpc.make_regular_ldpc(20, seed=0),
    "regular_K1024": lambda: jldpc.make_regular_ldpc(1024, seed=0),
    "parity_only_K4096": lambda: jldpc.make_parity_only_ldpc(4096, seed=0),
    "ldgm_K512": lambda: jldpc.make_seeded_ldgm(512, 256, row_weight=8, seed=0),
}


@functools.cache
def _code(name):
    """The JAX package's code and the port's tables of it on the CPU."""
    jc = _CODES[name]()
    return jc, decoder.code_tables(code_from(jc), "cpu")


@pytest.mark.parametrize("name", list(_CODES))
def test_column_table_is_the_columns_of_h(name):
    jc, tables = _code(name)
    col_ptr, col_rows = ref.column_table(tables.check_idx, tables.N)
    assert col_ptr.dtype == col_rows.dtype == torch.int32
    assert col_ptr.shape == (jc.N + 1,) and int(col_ptr[0]) == 0
    # np.nonzero of H's transpose: column by column, rows ascending
    cols, rows = np.nonzero(np.asarray(jc.H).T != 0)
    np.testing.assert_array_equal(np.diff(col_ptr.numpy()), np.bincount(cols, minlength=jc.N))
    np.testing.assert_array_equal(col_rows.numpy(), rows)
    if name == "ldgm_K512":
        deg = np.diff(col_ptr.numpy())
        assert set(deg[jc.K:]) == {1} and set(deg[:jc.K]) == {4}


def test_column_table_skips_the_padding():
    N = 7
    idx = torch.tensor([[0, 3, 6, N], [1, 3, N, N], [2, 4, 5, 6], [3, N, N, N]],
                       dtype=torch.int32)
    col_ptr, col_rows = ref.column_table(idx, N)
    want = [[0], [1], [2], [0, 1, 3], [2], [2], [0, 2]]
    assert [col_rows[col_ptr[j]:col_ptr[j + 1]].tolist() for j in range(N)] == want


def _trajectory(tables, values, erased, budgets):
    """The plain decode's per-slot trajectory under ``budgets`` (the
    adaptive contract's rules), yielding each round's start state."""
    vals, e = values.clone(), erased.clone()
    d = torch.zeros(e.shape[0], dtype=torch.int32)
    active = (budgets > 0) & e.any(dim=-1)
    while True:
        yield e, active
        if not bool(active.any()):
            return
        v2, e2 = ref.table_round(tables.check_idx, tables.check_coeff, vals, e)
        changed = (e2 != e).any(dim=-1)
        vals = torch.where(active[:, None, None], v2, vals)
        e = torch.where(active[:, None], e2, e)
        d = d + active.to(torch.int32)
        active = active & (d < budgets) & changed & e.any(dim=-1)


@pytest.mark.parametrize("f", [0.0, 0.25, 0.45])
@pytest.mark.parametrize("name", ["regular_K1024", "ldgm_K512"])
def test_counts_through_the_column_table_are_h_e_along_the_trajectory(name, f):
    jc, tables = _code(name)
    H = torch.from_numpy(np.asarray(jc.H) != 0).to(torch.int64)
    p = H.shape[0]
    col_ptr, col_rows = ref.column_table(tables.check_idx, tables.N)
    rng = np.random.default_rng(len(name) + int(100 * f))
    B = 8
    erased = torch.from_numpy(rng.random((B, jc.N)) < f)
    values = torch.from_numpy(rng.standard_normal((B, jc.N, 2)).astype(np.float32))
    budgets = torch.tensor([0, 1, 3, 8, 0, jc.N, 2, jc.N], dtype=torch.int32)
    cnt = ref.column_counts(col_ptr, col_rows, p, erased)
    xr = ref.column_xors(col_ptr, col_rows, p, erased)
    cols = torch.arange(jc.N)
    prev = None
    rounds = 0
    for e, active in _trajectory(tables, values, erased, budgets):
        if prev is not None:
            pe, pcnt, pactive = prev
            gone = pe & ~e
            # what a round resolved: the erased coordinates with a row of
            # count 1 at its start, on active slots
            ones = torch.zeros((B, p + 1), dtype=torch.int64)
            ones[:, :p] = (pcnt == 1).to(torch.int64)
            deg = (col_ptr[1:] - col_ptr[:-1]).long()
            col_of = torch.arange(jc.N).repeat_interleave(deg)
            solvable = torch.zeros((B, jc.N), dtype=torch.int64).index_add_(
                1, col_of, ones[:, col_rows.long()]) > 0
            assert torch.equal(gone, solvable & pe & pactive[:, None])
            cnt = cnt - ref.column_counts(col_ptr, col_rows, p, gone)
            xr = xr ^ ref.column_xors(col_ptr, col_rows, p, gone)
        assert torch.equal(cnt, e.to(torch.int64) @ H.T)
        # a row of one erased neighbour holds that neighbour's column
        one = cnt == 1
        assert torch.equal(xr[one], ((e.to(torch.int64) * cols) @ H.T)[one])
        prev = (e, cnt, active)
        rounds += 1
    assert torch.equal(erased[[0, 4]], prev[0][[0, 4]])       # budget 0: untouched
    if f > 0:
        assert rounds > 2 and bool((erased & ~prev[0]).any())


def test_wrapper_column_table_is_never_stale():
    _, tables = _code("regular_K20")
    idx = tables.check_idx.clone()
    first = ops._column_table(idx, tables.N)
    assert ops._column_table(idx, tables.N) is first            # kept while unchanged
    idx[0, 0] = 1 if int(idx[0, 0]) != 1 else 0                 # an in-place change
    again = ops._column_table(idx, tables.N)
    assert again is not first
    for a, b in zip(again, ref.column_table(idx, tables.N)):
        assert torch.equal(a, b)
    # another N over the same tensor: the sentinel moves, so it is rebuilt
    wide = ops._column_table(idx, tables.N + 5)
    assert wide[0].shape == (tables.N + 6,)
    # a _replace'd table brings a tensor of its own
    stride = 3
    spread = tables._replace(check_idx=tables.check_idx * stride, N=tables.N * stride)
    col_ptr, col_rows = ops._column_table(spread.check_idx, spread.N)
    base_ptr, base_rows = ref.column_table(tables.check_idx, tables.N)
    assert torch.equal(col_ptr[::stride][:tables.N + 1], base_ptr)
    assert torch.equal(col_rows, base_rows)


def test_table_layout_puts_the_state_on_chip_where_it_fits():
    def tables(p, r, N):
        return CodeTables(torch.zeros((p, r), dtype=torch.int32),
                          torch.zeros((p, r)), N)

    # Path A's LDGM (p = 8192, r = 9, N = 24,576): two bits a coordinate, a
    # byte and an int a row, then its one payload column; not its 0.9 MB of
    # tables
    assert ops._state_bytes(24576, 8192, 9) == 2 * 24576 // 8 + 8192 + 4 * 8192
    assert ops.table_layout(tables(8192, 9, 24576), 1, 1) == ((1, 1), True, True, False)
    # phase 15's (3, 6) code (N = 49,152): the state; two columns would not fit
    assert ops.table_layout(tables(24576, 6, 49152), 4, 2) == ((1, 4), True, False, False)
    # the blocked step's (N = 2048): everything, 4 of the 32 columns a block
    small = ops.table_layout(tables(1024, 6, 2048), 64, 32)
    assert small == ((8, 64), True, True, True) and small.place == 7
    assert ops._smem_bytes(2048, 1024, 6, 32, 7) == (ops._smem_bytes(2048, 1024, 6)
                                                     + 2048 * 16 + 3 * 1024 * 6 * 4 + 2049 * 4
                                                     + 12)
    assert ops._smem_bytes(2048, 1024, 6, 3, 3) == ops._smem_bytes(2048, 1024, 6, 4, 3)
    # two-byte counts past a row weight of 255
    assert ops._state_bytes(2048, 1024, 256) == ops._state_bytes(2048, 1024, 255) + 1024
    # past a block's shared memory: the state in device memory, and nothing else on chip
    N = 300_000
    assert ops._smem_bytes(N, N // 2, 6) > ops.MAX_SMEM_BYTES
    assert ops.table_layout(tables(N // 2, 6, N), 1, 5) == ((2, 1), False, False, False)
