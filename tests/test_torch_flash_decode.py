"""The decode kernel's split and combine against the JAX package's attention,
on the CPU.

The split-KV decode kernel (``csrc/flash_attention.cu``,
``flash_decode_kernel``) cuts the keys' 32-key tiles into ``splits``
ranges, forms each range's partial (m, l, acc) in f32 and folds them in
ascending split order.  Its plain version is ``ref.attention_split_ref``;
here it is held against

* the JAX Pallas kernel ``flash_attention`` in interpret mode (as
  tests/test_kernels.py runs it) at decode shapes (one query that sees
  every key), 1, 2 and 8 query heads per KV head, f32 and bf16, with 1, 2,
  3 and 7 splits and more splits than tiles;
* the JAX ``models.attention.sdpa_chunked``: a wrapped ring buffer with
  ``INT32_MAX`` slots and ``kv_valid``, two queries of 8 heads (16 rows),
  and queries before every key (the mean of v over all T keys, across
  every split);

and the rule the kernel skips tiles by, run on each split's keys alone, is
held to an online softmax over only the kept tiles of each split, folded
across splits, in float64 against the full softmax.  Tolerances as in
tests/test_torch_flash.py: F32_ULPS units of 2⁻²³·max|v| in f32, one bf16
ulp of the output beyond that in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention
from repro.models.attention import sdpa_chunked
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (TILE_KEYS, attention_ref,
                                                     attention_split_ref, split_bounds,
                                                     tiles_visited, visited_tiles)

from test_torch_flash import INT32_MAX, _close, _inputs, _pair, _ring

SPLITS = (1, 2, 3, 7, 40)            # 40: more splits than the 7 tiles of T = 200


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_split_version_matches_jax_flash_kernel_at_decode(G, dtype):
    B, KV, T, Dh = 2, 2, 200, 64
    q, k, v = _inputs(B, 1, T, KV, G, Dh, seed=[G, T, len(dtype)])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    # one query at the last position sees every key: flash_call without the mask
    want = np.asarray(flash_attention(jq.reshape(B, 1, KV * G, Dh), jk, jv, causal=False,
                                      interpret=True), np.float32).reshape(B, 1, KV, G, Dh)
    q_pos = torch.tensor([T - 1], dtype=torch.int32)
    kv_pos = torch.arange(T, dtype=torch.int32)
    for splits in SPLITS:
        got = attention_split_ref(tq, tk, tv, q_pos, kv_pos, splits=splits)
        assert got.shape == (B, 1, KV, G, Dh)
        _close(got, want, v, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["ring", "two_queries", "before_every_key"])
def test_split_version_matches_sdpa_chunked(case, dtype):
    B, KV, G, Dh, T = 2, 2, 2, 128, 150
    Sq, q_pos = 1, np.array([T + 40], np.int32)
    kv_pos, kv_valid = np.arange(T, dtype=np.int32), None
    if case == "ring":                   # wrapped, two empty slots
        kv_pos = _ring(T, int(q_pos[0]), seed=61)
        kv_valid = kv_pos <= int(q_pos[0])
    elif case == "two_queries":          # 2 queries x 8 heads: the kernel's 16 rows
        G, Sq, q_pos = 8, 2, np.array([60, 149], np.int32)
        kv_valid = np.random.default_rng(3).random(T) < 0.8
    else:                                # the first query sees no key at all
        Sq, q_pos = 2, np.array([-1, 70], np.int32)
    q, k, v = _inputs(B, Sq, T, KV, G, Dh, seed=[Sq, G, len(case)])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = sdpa_chunked(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True,
                        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    tvalid = None if kv_valid is None else torch.from_numpy(kv_valid)
    for splits in SPLITS:
        got = attention_split_ref(tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                                  splits=splits, kv_valid=tvalid)
        _close(got, want, v, dtype)
        if case == "before_every_key":   # the mean of v over all T keys, every split
            mean = tv.double().mean(1).numpy()                  # (B, KV, Dh)
            if dtype == "f32":
                np.testing.assert_allclose(got[:, 0, :, 0].numpy(), mean, atol=1e-6)
            else:
                _close(got[:, :1], np.repeat(mean[:, None, :, None], G, 3), v, dtype)


def test_split_bounds_cut_whole_tiles_in_order():
    for T in (1, 31, 32, 33, 200, 2080):
        n = -(-T // 32)
        for splits in (1, 2, 3, 7, 9, n, n + 5):
            keys = split_bounds(T, splits)
            assert len(keys) == splits
            assert [t for r in keys for t in r] == list(range(T))     # every key, once
            assert all(r.start % 32 == 0 for r in keys if len(r))     # whole tiles
            sizes = [-(-len(r) // 32) for r in keys]
            assert max(sizes) - min(sizes) <= 1 or splits > n


def test_split_count_rule():
    # at least two blocks an SM, no split under two tiles, at least one split
    assert ops.split_count(2080, 4, 8, 132) == 9              # Qwen3-1.7B's decode: 288 blocks
    assert ops.split_count(2080, 4, 8, 132) * 32 >= 2 * 132
    assert ops.split_count(1, 4, 8, 132) == 1
    assert ops.split_count(33, 1, 1, 132) == 1                 # 2 tiles: one split
    assert ops.split_count(4096, 1, 1, 132) == 64              # 128 tiles, 2 a split
    assert ops.split_count(4096, 64, 8, 132) == 1              # 512 blocks without a cut
    assert ops.split_count(2080, 4, 8, 78) == 5                # fewer SMs, fewer splits
    for T in (1, 100, 2080, 10 ** 6):
        for bkv in (1, 7, 32, 4096):
            s = ops.split_count(T, bkv, 1, 132)
            assert 1 <= s <= max(1, -(-T // 32) // 2)


def _online_over_kept_splits(q, k, v, q_pos, kv_pos, *, causal, kv_valid, splits):
    """float64 attention as the decode kernel takes it: for each split an
    online softmax over only the tiles ref.visited_tiles keeps of the
    split's keys, the splits folded in ascending order."""
    B, Sq, KV, G, Dh = q.shape
    scale = 1.0 / np.sqrt(Dh)
    valid = np.ones(len(kv_pos), bool) if kv_valid is None else kv_valid
    M = np.full((B, Sq, KV, G), -1e30)
    L = np.zeros(M.shape)
    A = np.zeros(M.shape + (v.shape[3],))
    n_kept = 0
    for keys in split_bounds(len(kv_pos), splits):
        m, l, acc = np.full(M.shape, -1e30), np.zeros(M.shape), np.zeros(A.shape)
        if len(keys):
            kp, vd = kv_pos[keys.start:keys.stop], valid[keys.start:keys.stop]
            kept = visited_tiles(torch.from_numpy(q_pos), torch.from_numpy(kp), bk=32,
                                 causal=causal, kv_valid=torch.from_numpy(vd))
            n_kept += len(kept)
            for j in kept:
                sl = slice(keys.start + 32 * j, min(keys.start + 32 * (j + 1), keys.stop))
                s = np.einsum("bqkgd,btkd->bqkgt", q, k[:, sl]) * scale
                vis = valid[sl][None, :] & ((kv_pos[sl][None, :] <= q_pos[:, None]) if causal
                                            else True)
                s = np.where(vis[None, :, None, None, :], s, -1e30)
                m_new = np.maximum(m, s.max(-1))
                alpha = np.exp(m - m_new)
                p = np.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + np.einsum("bqkgt,btkd->bqkgd", p, v[:, sl])
                m = m_new
        mx = np.maximum(M, m)
        wa, wb = np.exp(M - mx), np.exp(m - mx)
        M, L, A = mx, L * wa + l * wb, A * wa[..., None] + acc * wb[..., None]
    return A / np.maximum(L, 1e-30)[..., None], n_kept


@pytest.mark.parametrize("case", ["decode", "ring", "holes", "before_every_key", "prefill_rows"])
@pytest.mark.parametrize("splits", [1, 3, 9])
def test_online_over_kept_tiles_of_each_split_is_the_full_softmax(case, splits):
    B, KV, G, Dh, T = 1, 2, 2, 32, 300
    q_pos, kv_pos, kv_valid, causal = np.array([299], np.int32), np.arange(T, dtype=np.int32), \
        None, True
    rng = np.random.default_rng([T, splits, len(case)])
    if case == "ring":
        q_pos = np.array([700], np.int32)
        kv_pos = _ring(T, 700, seed=41)
        kv_valid = kv_pos <= 700
    elif case == "holes":                 # whole tiles with no valid key
        kv_valid = rng.random(T) < 0.6
        kv_valid[:100] = False
        kv_valid[200:260] = False
    elif case == "before_every_key":
        q_pos = np.array([-4, 3, 150], np.int32)
    elif case == "prefill_rows":          # 8 queries of a prefill's tail: skips inside splits
        q_pos = np.arange(8, dtype=np.int32) * 9
        G = 2
    q, k, v = (a.astype(np.float64) for a in _inputs(B, len(q_pos), T, KV, G, Dh,
                                                     seed=[T, len(case)]))
    got, n_kept = _online_over_kept_splits(q, k, v, q_pos, kv_pos, causal=causal,
                                           kv_valid=kv_valid, splits=splits)
    tv = None if kv_valid is None else torch.from_numpy(kv_valid)
    full = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(q_pos),
                         torch.from_numpy(kv_pos), causal=causal, kv_valid=tv)
    np.testing.assert_allclose(got, full.numpy(), rtol=0, atol=1e-12)
    assert n_kept == tiles_visited(q_pos, kv_pos, B=1, KV=1, G=G, Dh=Dh, Dv=Dh, path="decode",
                                   causal=causal, kv_valid=tv, splits=splits)
    if case in ("holes", "prefill_rows") and splits < 9:
        assert n_kept < -(-T // 32)       # the rule does skip there (a split keeps its first)


def test_tiles_visited_on_the_decode_path():
    T = 200                               # 7 tiles
    pos = torch.arange(T, dtype=torch.int32)
    last = torch.tensor([T - 1], dtype=torch.int32)
    kw = dict(B=2, KV=3, G=2, Dh=64, Dv=64, path="decode")
    for splits in (1, 2, 7, 40):          # every tile kept, whatever the cut
        assert tiles_visited(last, pos, splits=splits, **kw) == 2 * 3 * 7
    # no key visible to the query at position 40 past tile 1: tiles 2.. are skipped
    # in split 0, but each later split keeps its tiles up to its first tile
    # with a key the query sees, and with none, all of them (the mean of v)
    early = torch.tensor([40], dtype=torch.int32)
    assert tiles_visited(early, pos, splits=1, **kw) == 2 * 3 * 2
    assert tiles_visited(early, pos, splits=7, **kw) == 2 * 3 * 7
    per_split = [len(visited_tiles(early, pos[r.start:r.stop], bk=TILE_KEYS["decode"]))
                 for r in split_bounds(T, 3) if len(r)]
    assert tiles_visited(early, pos, splits=3, **kw) == 2 * 3 * sum(per_split)
    with pytest.raises(ValueError):
        tiles_visited(last, pos, **kw)    # the decode path needs its split count


def test_cpu_tensors_run_the_plain_version_whatever_the_splits():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 70, 2, 2, 64, seed=4))
    q_pos, kv_pos = torch.tensor([69], dtype=torch.int32), torch.arange(70, dtype=torch.int32)
    before = ops.flash_attention_cuda.launches
    plain = attention_ref(q, k, v, q_pos, kv_pos)
    assert torch.equal(ops.flash_attention_cuda(q, k, v, q_pos, kv_pos), plain)
    for splits in (1, 3):
        with ops.forced_splits(splits):
            assert torch.equal(ops.flash_attention_cuda(q, k, v, q_pos, kv_pos), plain)
    assert ops.flash_attention_cuda.launches == before
    with pytest.raises(ValueError):
        with ops.forced_splits(0):
            pass
    assert INT32_MAX == np.iinfo(np.int32).max
