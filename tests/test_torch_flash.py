"""The port's attention core against the JAX package's, on the CPU.

On CPU tensors the flash kernel's wrapper
(``repro_torch.kernels.flash_attention.flash_attention_cuda``, which
``repro_torch.models.attention.sdpa_chunked`` calls) runs the kernel's
plain version, ``ref.attention_ref``.  It is held here against

* the JAX Pallas kernel ``flash_attention`` in interpret mode (as
  tests/test_kernels.py runs it): causal and not, 1, 2 and 4 query heads
  per KV head (MQA included), Sq ≠ Sk, lengths that are not tile
  multiples, head dimensions 32, 64 and 128, f32 and bf16;
* the JAX ``models.attention.sdpa_chunked``: query positions shifted
  against the keys', a wrapped ring buffer with ``INT32_MAX`` slots and
  ``kv_valid``, and query chunks that do and do not divide Sq;
* head dimensions the dense family does not use: odd ones (40, 48, 96,
  200) against the Pallas kernel (which takes Dv = Dh only), and v's head
  dimension apart from q's and k's (MLA: 192 with 128 at deepseek-v2's
  width, 48 with 32 reduced) against ``sdpa_chunked``, prefill and
  decode, 1 and 2 query heads per KV head.

The same numpy inputs go to both.  Tolerances: f32 outputs within
F32_ULPS units of 2⁻²³·max|v| (both compute in f32; the online softmax of
the Pallas kernel and the full softmax of the plain version sum in other
orders).  bf16 outputs within one bf16 ulp of the output beyond that f32
bound: both compute in f32 from the same bf16 inputs and round once, so
two f32 values a hair apart on either side of a rounding boundary land one
ulp apart, and near zero the f32 difference itself spans several of the
output's ulps.  The card tests (tests/test_torch_cuda.py) hold the kernel
to the plain version with the same two tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention
from repro.models.attention import sdpa_chunked
from repro_torch.kernels.flash_attention import attention_ref, flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import bf16_ulp

F32_ULPS = 4
INT32_MAX = np.iinfo(np.int32).max


def _inputs(B, Sq, T, KV, G, Dh, seed, Dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, KV, G, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, Dh if Dv is None else Dv)).astype(np.float32)
    return q, k, v


def _pair(a, dtype):
    """The same array as a JAX and a torch array of ``dtype`` (the same
    rounding to bf16 on both sides)."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    t = torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return j, t


def _excess(got: np.ndarray, want: np.ndarray, v: np.ndarray, dtype: str) -> float:
    """How far ``got`` lies beyond its tolerance about ``want`` at its worst
    output: at most 0 when held."""
    err = np.abs(got - want)
    tol = F32_ULPS * 2.0 ** -23 * np.abs(v).max()
    if dtype == "bf16":
        tol = tol + bf16_ulp(torch.from_numpy(np.maximum(np.abs(got), np.abs(want)))).numpy()
    return float((err - tol).max())


def _close(got: torch.Tensor, want, v: np.ndarray, dtype: str):
    want = np.asarray(want, np.float32)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    excess = _excess(got, want, v, dtype)
    assert excess <= 0, excess


CASES = [  # causal, G, Sq, Sk, Dh, dtype
    (True, 1, 100, 100, 64, "f32"), (False, 1, 100, 100, 64, "f32"),
    (True, 2, 17, 17, 32, "f32"), (True, 4, 17, 100, 128, "f32"),
    (False, 4, 100, 17, 128, "f32"), (False, 2, 100, 100, 32, "f32"),
    (True, 2, 100, 100, 128, "bf16"), (False, 1, 17, 100, 64, "bf16"),
    (True, 4, 100, 17, 32, "bf16"), (False, 4, 17, 17, 128, "bf16"),
]


@pytest.mark.parametrize("causal,G,Sq,Sk,Dh,dtype", CASES)
def test_plain_version_matches_jax_flash_kernel(causal, G, Sq, Sk, Dh, dtype):
    B, KV = 2, 2
    q, k, v = _inputs(B, Sq, Sk, KV, G, Dh, seed=[Sq, Sk, G, Dh])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = flash_attention(jq.reshape(B, Sq, KV * G, Dh), jk, jv, causal=causal,
                           interpret=True)
    got = flash_attention_cuda(tq, tk, tv, torch.arange(Sq, dtype=torch.int32),
                               torch.arange(Sk, dtype=torch.int32), causal=causal)
    _close(got, np.asarray(want, np.float32).reshape(B, Sq, KV, G, Dh), v, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("Dh", [64, 128])
def test_p_rounded_once_to_bf16_fails_the_bf16_comparison(causal, G, Dh):
    # The tensor-core kernel takes p·v as three bf16 products (p = p1 + p2 +
    # p3).  Against the JAX Pallas kernel (p·v in f32), the plain version of
    # that split holds the bf16 comparison and the control, p rounded once
    # to bf16 (one product, as scaled_dot_product_attention takes it), does
    # not: the comparison sees p's precision.
    B, KV, S = 2, 2, 100
    q, k, v = _inputs(B, S, S, KV, G, Dh, seed=[G, Dh, int(causal), 23])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bf16") for a in (q, k, v))
    want = np.asarray(flash_attention(jq.reshape(B, S, KV * G, Dh), jk, jv, causal=causal,
                                      interpret=True), np.float32).reshape(B, S, KV, G, Dh)
    pos = torch.arange(S, dtype=torch.int32)
    v_bf16 = tv.float().numpy()
    split, one = (attention_ref(tq, tk, tv, pos, pos, causal=causal, p_terms=n).float().numpy()
                  for n in (3, 1))
    assert _excess(split, want, v_bf16, "bf16") <= 0
    assert _excess(one, want, v_bf16, "bf16") > 0


@pytest.mark.parametrize("causal,G,Dh,dtype", [(True, 2, 48, "f32"), (False, 1, 40, "f32"),
                                                (True, 1, 96, "bf16"), (True, 2, 200, "f32")])
def test_plain_version_matches_jax_flash_kernel_at_odd_head_dims(causal, G, Dh, dtype):
    B, KV, Sq, Sk = 1, 2, 20, 33
    q, k, v = _inputs(B, Sq, Sk, KV, G, Dh, seed=[Dh, G])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = flash_attention(jq.reshape(B, Sq, KV * G, Dh), jk, jv, causal=causal,
                           interpret=True)
    got = flash_attention_cuda(tq, tk, tv, torch.arange(Sq, dtype=torch.int32),
                               torch.arange(Sk, dtype=torch.int32), causal=causal)
    _close(got, np.asarray(want, np.float32).reshape(B, Sq, KV, G, Dh), v, dtype)


@pytest.mark.parametrize("Dh,Dv", [(192, 128), (48, 32), (40, 24), (32, 100)])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("decode", [False, True])
def test_plain_version_matches_sdpa_chunked_with_dv_apart(Dh, Dv, G, decode):
    B, KV, T = 1, 2, 24
    Sq = 1 if decode else T
    q, k, v = _inputs(B, Sq, T, KV, G, Dh, seed=[Dh, Dv, G, Sq], Dv=Dv)
    q_pos = np.arange(T - Sq, T, dtype=np.int32)
    kv_pos = np.arange(T, dtype=np.int32)
    for dtype in ("f32", "bf16"):
        (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
        want = sdpa_chunked(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True,
                            chunk=8)
        got = flash_attention_cuda(tq, tk, tv, torch.from_numpy(q_pos),
                                   torch.from_numpy(kv_pos), causal=True, chunk=8)
        assert got.shape == (B, Sq, KV, G, Dv)
        _close(got, want, v, dtype)


def _ring(T, p, seed):
    """A wrapped ring buffer of T slots at position p: slots hold positions
    p-T+3..p rotated, and two slots are empty (INT32_MAX)."""
    pos = np.roll(np.arange(p - T + 1, p + 1), seed % T).astype(np.int32)
    pos[[1, T // 2]] = INT32_MAX
    return pos


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["shifted", "ring", "decode_ring", "chunked", "ragged_chunk",
                                  "one_chunk"])
def test_plain_version_matches_sdpa_chunked(case, dtype):
    B, KV, G, Dh = 2, 2, 2, 64
    Sq, T, chunk = 24, 24, 512
    q_pos = np.arange(Sq, dtype=np.int32)
    kv_pos, kv_valid = np.arange(T, dtype=np.int32), None
    if case == "shifted":             # the queries are the last Sq of T keys
        T = 40
        q_pos, kv_pos = q_pos + 16, np.arange(T, dtype=np.int32)
    elif case in ("ring", "decode_ring"):
        T = 16
        if case == "decode_ring":
            Sq, q_pos = 1, np.array([37], np.int32)
        else:
            q_pos = np.arange(30, 30 + Sq, dtype=np.int32)
        kv_pos = _ring(T, int(q_pos.max()), seed=5)
        kv_valid = kv_pos <= int(q_pos[-1])
    elif case == "chunked":
        chunk = 8                     # divides Sq: three chunks
    elif case == "ragged_chunk":
        chunk = 7                     # does not divide Sq: one block
    else:
        chunk = Sq
    q, k, v = _inputs(B, Sq, T, KV, G, Dh, seed=[Sq, T, chunk])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = sdpa_chunked(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True,
                        chunk=chunk,
                        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    got = flash_attention_cuda(tq, tk, tv, torch.from_numpy(q_pos),
                               torch.from_numpy(kv_pos), causal=True, chunk=chunk,
                               kv_valid=None if kv_valid is None
                               else torch.from_numpy(kv_valid))
    _close(got, want, v, dtype)


def test_a_row_with_every_key_masked_is_the_mean_of_v():
    q, k, v = _inputs(1, 3, 9, 1, 2, 32, seed=7)
    q_pos = torch.tensor([-1, 0, 8], dtype=torch.int32)
    got = flash_attention_cuda(*(torch.from_numpy(a) for a in (q, k, v)), q_pos,
                               torch.arange(9, dtype=torch.int32))
    want = sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(q_pos.numpy()), jnp.arange(9))
    _close(got, want, v, "f32")
    np.testing.assert_allclose(got[0, 0, 0, 0].numpy(), v[0, :, 0].mean(0), atol=1e-6)


def _bad(which):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 6, 2, 2, 32, seed=1))
    qp, kp = torch.arange(4, dtype=torch.int32), torch.arange(6, dtype=torch.int32)
    kw = {}
    if which == "half":
        q, k, v = q.half(), k.half(), v.half()
    elif which == "mixed_dtypes":
        k = k.to(torch.bfloat16)
    elif which == "q_shape":
        q = q[:, :, :1].contiguous()
    elif which == "kv_shape":
        v = v[:, :5].contiguous()
    elif which == "noncontiguous":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif which == "pos_dtype":
        kp = kp.long()
    elif which == "pos_shape":
        qp = qp[:3]
    elif which == "valid_dtype":
        kw["kv_valid"] = torch.ones(6, dtype=torch.uint8)
    elif which == "valid_shape":
        kw["kv_valid"] = torch.ones(5, dtype=torch.bool)
    elif which == "rank":
        q = q[:, :, 0]
    return q, k, v, qp, kp, kw


@pytest.mark.parametrize("which", ["half", "mixed_dtypes", "q_shape", "kv_shape",
                                   "noncontiguous", "pos_dtype", "pos_shape", "valid_dtype",
                                   "valid_shape", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(which):
    q, k, v, qp, kp, kw = _bad(which)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v, qp, kp, **kw)


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 5, 5, 1, 2, 64, seed=2))
    pos = torch.arange(5, dtype=torch.int32)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, pos, pos)
    assert flash_attention_cuda.launches == before
    assert torch.equal(got, attention_ref(q, k, v, pos, pos))


# ------------------------------------------------------------- the causal skip
# The kernels skip a key tile when no key in it is visible to any row of the
# block and every row has met a visible key before it
# (ref.visited_tiles, the rule's plain version).  On causal prefill with
# ascending positions that is the loop range of JAX's flash_call at the same
# tile sizes; anywhere, an online softmax over only the kept tiles is the
# full softmax.

from repro.kernels.flash_attention.kernel import flash_call  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (TILE_KEYS, query_tiles,  # noqa: E402
                                                     tiles_visited, visited_tiles)


@pytest.mark.parametrize("path", ["tensor", "simt"])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_skip_rule_keeps_jax_flash_calls_loop_range(path, G, causal):
    # Which key tiles flash_call reads, seen from outside: batch-head b
    # carries NaN in v's key tile b, and a query tile's output is NaN where
    # its loop read that tile (p·v with any p, 0 included, is NaN there).
    S, bk = 128, TILE_KEYS[path]
    bq = query_tiles(S, G)[0].stop
    n_kv = S // bk
    rng = np.random.default_rng([S, bk, G])
    q = rng.standard_normal((n_kv, S, 32)).astype(np.float32)
    k = rng.standard_normal((n_kv, S, 32)).astype(np.float32)
    v = rng.standard_normal((n_kv, S, 32)).astype(np.float32)
    for j in range(n_kv):
        v[j, j * bk:(j + 1) * bk] = np.nan
    out = np.asarray(flash_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=bq, bk=bk,
                                causal=causal, interpret=True))
    pos = torch.arange(S, dtype=torch.int32)
    for i, rows in enumerate(query_tiles(S, G)):
        read = [j for j in range(n_kv) if np.isnan(out[j, rows.start:rows.stop]).any()]
        kept = visited_tiles(pos[rows.start:rows.stop], pos, bk=bk, causal=causal)
        assert kept == read, (i, kept, read)
        if causal:                        # kernel.py:38, upper
            assert len(kept) == min(n_kv, (i * bq + bq + bk - 1) // bk)


def _online_over_kept(q, k, v, q_pos, kv_pos, *, causal, kv_valid, bk):
    """float64 attention by the kernels' online softmax, block by block,
    over only the key tiles ref.visited_tiles keeps."""
    B, Sq, KV, G, Dh = q.shape
    T = k.shape[1]
    scale = 1.0 / np.sqrt(Dh)
    valid = np.ones(T, bool) if kv_valid is None else kv_valid
    out = np.zeros(q.shape[:4] + (v.shape[3],))
    n_kept = 0
    for rows in query_tiles(Sq, G):
        qb = q[:, rows.start:rows.stop]                       # (B, bq, KV, G, Dh)
        qp = q_pos[rows.start:rows.stop]
        m = np.full(qb.shape[:4], -1e30)
        l = np.zeros(qb.shape[:4])
        acc = np.zeros(qb.shape[:4] + (v.shape[3],))
        kept = visited_tiles(torch.from_numpy(qp), torch.from_numpy(kv_pos), bk=bk,
                             causal=causal, kv_valid=torch.from_numpy(valid))
        n_kept += len(kept)
        for j in kept:
            keys = slice(j * bk, min((j + 1) * bk, T))
            s = np.einsum("bqkgd,btkd->bqkgt", qb, k[:, keys]) * scale
            vis = valid[keys][None, :] & ((kv_pos[keys][None, :] <= qp[:, None]) if causal
                                          else True)
            s = np.where(vis[None, :, None, None, :], s, -1e30)
            m_new = np.maximum(m, s.max(-1))
            alpha = np.exp(m - m_new)
            p = np.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + np.einsum("bqkgt,btkd->bqkgd", p, v[:, keys])
            m = m_new
        out[:, rows.start:rows.stop] = acc / np.maximum(l, 1e-30)[..., None]
    return out, n_kept


@pytest.mark.parametrize("path", ["tensor", "simt"])
@pytest.mark.parametrize("case", ["prefill", "ring", "decode_ring", "before_every_key",
                                  "holes", "not_causal_holes"])
def test_online_softmax_over_kept_tiles_is_the_full_softmax(path, case):
    B, KV, G, Dh = 1, 2, 2, 32
    bk = TILE_KEYS[path]
    Sq = T = 150
    q_pos = np.arange(Sq, dtype=np.int32)
    kv_pos, kv_valid, causal = np.arange(T, dtype=np.int32), None, True
    rng = np.random.default_rng([Sq, bk, len(case)])
    if case in ("ring", "decode_ring"):   # a wrapped ring with two empty slots
        Sq = 40 if case == "ring" else 1
        q_pos = np.arange(400 - Sq, 400, dtype=np.int32)
        kv_pos = _ring(T, 399, seed=97)
        kv_valid = kv_pos <= 399
    elif case == "before_every_key":      # the first rows see no key at all
        Sq = 5
        q_pos = np.array([-3, -2, -1, 40, 149], np.int32)
    elif case in ("holes", "not_causal_holes"):
        kv_valid = rng.random(T) < 0.7
        kv_valid[:70] = False             # the first tiles hold no valid key
        causal = case == "holes"
    q, k, v = (a.astype(np.float64) for a in _inputs(B, Sq, T, KV, G, Dh, seed=[T, Sq]))
    got, n_kept = _online_over_kept(q, k, v, q_pos, kv_pos, causal=causal, kv_valid=kv_valid,
                                    bk=bk)
    tv = None if kv_valid is None else torch.from_numpy(kv_valid)
    full = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(q_pos),
                         torch.from_numpy(kv_pos), causal=causal, kv_valid=tv)
    np.testing.assert_allclose(got, full.numpy(), rtol=0, atol=1e-12)
    n_all = len(query_tiles(Sq, G)) * -(-T // bk)
    assert n_kept == tiles_visited(q_pos, kv_pos, B=1, KV=1, G=G, Dh=Dh, Dv=Dh, path=path,
                                   causal=causal, kv_valid=tv)
    if case in ("prefill", "holes"):
        assert n_kept < n_all             # the rule does skip here
    # and JAX's sdpa_chunked (which computes in f32) agrees with both
    want = sdpa_chunked(*(jnp.asarray(a.astype(np.float32)) for a in (q, k, v)),
                        jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=causal,
                        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    _close(torch.from_numpy(got.astype(np.float32)), want, v, "f32")


@pytest.mark.parametrize("Dh,Dv", [(576, 64), (576, 512), (1024, 64), (1024, 512)])
@pytest.mark.parametrize("decode", [False, True])
def test_plain_version_matches_sdpa_chunked_past_the_old_head_dim_cap(Dh, Dv, decode):
    # Dh = 576 is MLA's absorbed q·k width (512 + 64); the kernels took at
    # most 559 before.  f32.  The scores' rounding grows with Dh, so these
    # cases are held to a float64 anchor (the plain version in float64 on
    # the same inputs): the port within twice JAX's distance from it, plus
    # F32_ULPS units of 2⁻²³·max|v|.
    B, KV, G, T = 1, 2, 2, 40
    Sq = 1 if decode else 37
    q, k, v = _inputs(B, Sq, T, KV, G, Dh, seed=[Dh, Dv, Sq], Dv=Dv)
    q_pos = np.arange(T - Sq, T, dtype=np.int32)
    kv_pos = np.arange(T, dtype=np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "f32") for a in (q, k, v))
    want = sdpa_chunked(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True)
    got = flash_attention_cuda(tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(kv_pos))
    assert got.shape == (B, Sq, KV, G, Dv)
    exact = attention_ref(*(torch.from_numpy(a).double() for a in (q, k, v)),
                          torch.from_numpy(q_pos), torch.from_numpy(kv_pos)).numpy()
    port = np.abs(got.numpy() - exact).max()
    jax_err = np.abs(np.asarray(want, np.float64) - exact).max()
    assert np.isfinite(got.numpy()).all()
    assert port <= 2 * jax_err + F32_ULPS * 2.0 ** -23 * np.abs(v).max(), (port, jax_err)


def test_kernel_path_is_chosen_by_shape():
    # the tensor-core kernel: bf16, Dh = Dv in {64, 128}, Sq·G >= 64, and q, k,
    # v on 16-byte boundaries; the decode kernel: f32 or bf16, Dh = Dv in
    # {64, 128}, Sq·G <= 16, and q, k, v, kv_pos and kv_valid on 16-byte
    # boundaries; the SIMT kernel everything else
    from repro_torch.kernels.flash_attention.ops import kernel_path

    def path(Sq, G, Dh, Dv=None, dtype=torch.bfloat16, offset=0, kv_offset=0):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(1, Sq, 8, 1, G, Dh, seed=0, Dv=Dv))
        if offset:
            q = torch.cat([q.flatten(), q.flatten()[:offset]])[offset:].view(q.shape)
        if kv_offset:
            k = torch.cat([k.flatten(), k.flatten()[:kv_offset]])[kv_offset:].view(k.shape)
        return kernel_path(q, k, v)

    assert path(64, 1, 128) == path(32, 2, 64) == path(8, 8, 128) == "tensor"
    assert path(31, 2, 64) == "simt"                           # Sq·G < 64
    assert path(64, 1, 128, dtype=torch.float32) == "simt"
    assert path(64, 1, 96) == path(64, 1, 128, Dv=64) == "simt"
    assert path(64, 1, 128, offset=1) == "simt"                # 2 bytes off a boundary
    # decode: one query of up to 16 heads a KV head, or a few queries of fewer
    assert path(1, 2, 128) == path(1, 8, 64) == path(1, 1, 128) == "decode"
    assert path(2, 8, 128) == path(1, 16, 64) == path(16, 1, 128) == "decode"
    assert path(1, 2, 128, dtype=torch.float32) == path(4, 4, 64, dtype=torch.float32) == \
        "decode"
    assert path(1, 2, 128, offset=1) == "simt"                 # q copied 16 bytes at a time
    assert path(17, 1, 128) == path(3, 8, 64) == "simt"        # more than 16 rows
    assert path(1, 2, 96) == path(1, 2, 128, Dv=64) == path(1, 8, 576, Dv=512) == "simt"
    assert path(1, 2, 128, kv_offset=1) == "simt"              # k off a 16-byte boundary
    # the decode kernel copies the keys' positions and flags by TMA too: a
    # view of either off a 16-byte boundary goes to the SIMT kernel
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 1, 2, 128, seed=0))
    pos = torch.arange(9, dtype=torch.int32)
    flags = torch.ones(17, dtype=torch.bool)
    assert kernel_path(q, k, v, pos[:8], flags[:8]) == "decode"
    assert kernel_path(q, k, v, pos[1:], flags[:8]) == "simt"  # 4 bytes off
    assert kernel_path(q, k, v, pos[:8], flags[1:9]) == "simt"  # 1 byte off
    assert kernel_path(q, k, v, pos[1:]) == "simt"
    assert kernel_path(q, k, v, None, flags[:8]) == "decode"
