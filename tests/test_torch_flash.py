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
  ``kv_valid``, and query chunks that do and do not divide Sq.

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


def _inputs(B, Sq, T, KV, G, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, KV, G, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    return q, k, v


def _pair(a, dtype):
    """The same array as a JAX and a torch array of ``dtype`` (the same
    rounding to bf16 on both sides)."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    t = torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return j, t


def _close(got: torch.Tensor, want, v: np.ndarray, dtype: str):
    want = np.asarray(want, np.float32)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    f32_tol = F32_ULPS * 2.0 ** -23 * np.abs(v).max()
    if dtype == "bf16":
        ulp = bf16_ulp(torch.from_numpy(np.maximum(np.abs(got), np.abs(want)))).numpy()
        assert (err <= ulp + f32_tol).all(), float((err - ulp).max())
    else:
        assert err.max() <= f32_tol, err.max()


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
