"""The port's dense model family against the JAX package's, on the CPU.

Both packages serve the same model: the JAX ``Model.init(PRNGKey(0))``
weights are carried into the port by ``convert.model_from_params``, and the
same numpy tokens go to both.  On CPU tensors every attention layer runs the
flash kernel's plain version (tests/test_torch_flash.py holds it against
JAX's attention; tests/test_torch_cuda.py holds the kernel to it).  The
models are ``get_config(name).reduced()`` for qwen3-1.7b (qk-norm, 4 heads
over 2 KV heads) and qwen2-1.5b (QKV bias), with ``attn_chunk`` 8 on both
sides.

Tolerances.  The f32 logits (and caches) are anchored as the repo anchors
its decodes: the port's model run in float64 on the same weights gives the
reference's own error, and the port's f32 values must lie within
``4·max|JAX − port64| + 1e-5·max|JAX|`` of JAX's.  Greedy tokens must agree
wherever JAX's top-2 margin exceeds twice that bound.  In bf16 the casts
sit at the same points when the logits agree within 2 bf16 ulps of
max|logit| at the worst entry and half an ulp in RMS (measured: 1.75 and
0.40 ulps; with the f32 casts of rmsnorm and rope removed the port measures
3.0 and 0.68).
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_config as jget
from repro.configs import list_configs as jlist
from repro.models import Model as JModel
from repro.serving.batcher import Request as JRequest
from repro.serving.batcher import WaveBatcher as JWaveBatcher
from repro_torch import configs as tconfigs
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_configs as tlist
from repro_torch.convert import model_from_params
from repro_torch.launch import serve
from repro_torch.models import Model as TModel
from repro_torch.serving import Request, WaveBatcher

NAMES = ["qwen3-1.7b", "qwen2-1.5b"]


def _cfgs(name, **changes):
    j, t = jget(name).reduced(), tget(name).reduced()
    return dataclasses.replace(j, **changes), dataclasses.replace(t, **changes)


@functools.cache
def _models(name, dtype="float32", head_dim=None, seed=0):
    changes = {"dtype": dtype} | ({"head_dim": head_dim} if head_dim else {})
    jcfg, tcfg = _cfgs(name, **changes)
    jm = JModel(jcfg, remat=False, attn_chunk=8)
    params = jm.init(jax.random.PRNGKey(seed))
    arrays = jax.tree.map(np.asarray, params)
    port = model_from_params(tcfg, arrays, device="cpu", attn_chunk=8)
    port64 = model_from_params(tcfg, arrays, device="cpu", attn_chunk=8).to(torch.float64)
    return SimpleNamespace(cfg=jcfg, jm=jm, params=params, port=port, port64=port64,
                           prefill=jax.jit(jm.prefill), step=jax.jit(jm.decode_step))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _tol(want, anchor):
    want, anchor = np.asarray(want, np.float64), np.asarray(anchor, np.float64)
    return 4 * np.abs(want - anchor).max() + 1e-5 * np.abs(want).max()


def _close(got, want, anchor, what):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    tol = _tol(want, anchor.double().numpy())
    err = np.abs(got - np.asarray(want, np.float64)).max()
    assert err <= tol, f"{what}: {err} > {tol}"
    return tol


def _jax_layer(m, jcache, i):
    if i < m.jm.prefix_len:
        return jcache["prefix"][str(i)]
    b, j = divmod(i - m.jm.prefix_len, m.jm.period)
    return jax.tree.map(lambda a: a[b], jcache["blocks"][f"sub{j}"])


def _caches_close(m, jcache, c32, c64, what):
    for i, (t32, t64) in enumerate(zip(c32, c64)):
        jc = _jax_layer(m, jcache, i)
        for key in ("k", "v"):
            _close(t32[key], jc[key], t64[key], f"{what} layer {i} {key}")
        np.testing.assert_array_equal(t32["pos"].numpy(), np.asarray(jc["pos"]))
        assert int(t32["length"]) == int(jc["length"])


def _greedy_agrees(got, want, tol):
    top2 = np.sort(np.asarray(want, np.float64), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(got.numpy().argmax(-1)[clear],
                                  np.asarray(want).argmax(-1)[clear])


# ------------------------------------------------------------- configs

def test_config_copy_equals_jax_field_by_field():
    assert tlist() == jlist()
    for name in jlist():
        j, t = jget(name), tget(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced()), name
        assert t.stack_plan() == j.stack_plan() and t.layer_specs() == j.layer_specs()
        assert t.hd == j.hd
        assert str(t.torch_dtype).removeprefix("torch.") == jnp.dtype(j.jdtype).name
    from repro.configs import paper as jpaper
    from repro_torch.configs import paper as tpaper
    for name in jpaper.__all__[1:]:
        assert dataclasses.asdict(getattr(tpaper, name)) == \
            dataclasses.asdict(getattr(jpaper, name))
    assert tconfigs.__all__ == jconfigs.__all__


@pytest.mark.parametrize("name", [n for n in jlist() if jget(n).family != "dense"])
def test_other_families_are_not_ported_yet(name):
    with pytest.raises(NotImplementedError, match=jget(name).family):
        TModel(tget(name).reduced(), device="cpu")


# ------------------------------------------------------------- weights

@pytest.mark.parametrize("name", NAMES)
def test_weights_carry_across_with_every_projection_non_square(name):
    # head_dim 32: wq (256, 128), wk and wv (256, 64), wo (128, 256), the
    # MLP (256, 1024) and (1024, 256), the unembedding (512, 256): a
    # transposed weight fails to load or changes the logits.
    m = _models(name, head_dim=32)
    assert m.port.param_count() == m.jm.param_count(m.params)
    shapes = {k: tuple(v.shape) for k, v in m.port.state_dict().items()}
    assert all(s[0] != s[1] for s in shapes.values() if len(s) == 2)
    toks = _tokens(m.cfg, 2, 9, seed=1)
    want, _ = m.prefill(m.params, {"tokens": jnp.asarray(toks)}, m.jm.init_cache(2, 9))
    got, _ = m.port.prefill({"tokens": torch.from_numpy(toks)}, m.port.init_cache(2, 9))
    anchor, _ = m.port64.prefill({"tokens": torch.from_numpy(toks)},
                                 m.port64.init_cache(2, 9))
    _close(got, want, anchor, "logits")


@pytest.mark.parametrize("name", NAMES)
def test_param_count_equals_jax(name):
    m = _models(name)
    assert m.port.param_count() == m.jm.param_count(m.params)


# ------------------------------------------------------ prefill and decode

def _serve_both(m, B, prompt_len, steps, max_len, window=None, seed=2):
    """Prefill, then ``steps`` decode steps under teacher forcing (JAX's
    greedy tokens fed to all three models); every step's logits and every
    layer's cache compared."""
    toks = _tokens(m.cfg, B, prompt_len, seed)
    jcache = m.jm.init_cache(B, max_len, window=window)
    c32 = m.port.init_cache(B, max_len, window=window)
    c64 = m.port64.init_cache(B, max_len, window=window)
    jl, jcache = m.prefill(m.params, {"tokens": jnp.asarray(toks)}, jcache)
    tl, c32 = m.port.prefill({"tokens": torch.from_numpy(toks)}, c32)
    t64, c64 = m.port64.prefill({"tokens": torch.from_numpy(toks)}, c64)
    for t in range(steps + 1):
        tol = _close(tl, jl, t64, f"step {t} logits")
        _greedy_agrees(tl[:, -1], np.asarray(jl)[:, -1], tol)
        _caches_close(m, jcache, c32, c64, f"step {t}")
        if t == steps:
            return
        tok = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
        pos = prompt_len + t
        jl, jcache = m.step(m.params, jnp.asarray(tok), jnp.int32(pos), jcache)
        tl, c32 = m.port.decode_step(torch.from_numpy(tok), pos, c32)
        t64, c64 = m.port64.decode_step(torch.from_numpy(tok), pos, c64)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_teacher_forced_decode_match_jax(name):
    _serve_both(_models(name), B=2, prompt_len=8, steps=12, max_len=20)


@pytest.mark.parametrize("name", NAMES)
def test_ring_buffer_window_wraps_and_matches_jax(name):
    # window 16, an 8-token prompt and 24 steps: positions 8..31 write slots
    # pos % 16, so the ring wraps and old keys drop out.
    _serve_both(_models(name), B=2, prompt_len=8, steps=24, max_len=32, window=16)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_casts_sit_where_jax_puts_them(name):
    m = _models(name, dtype="bfloat16")
    toks = _tokens(m.cfg, 2, 12, seed=0)
    jl, jc = m.prefill(m.params, {"tokens": jnp.asarray(toks)}, m.jm.init_cache(2, 20))
    tl, tc = m.port.prefill({"tokens": torch.from_numpy(toks)}, m.port.init_cache(2, 20))
    assert m.port.embed.table.dtype == torch.bfloat16 and tc[0]["k"].dtype == torch.bfloat16
    outs = [(np.asarray(jl), tl.numpy())]
    for i in range(4):
        tok = outs[-1][0][:, -1].argmax(-1)[:, None].astype(np.int32)
        jl, jc = m.step(m.params, jnp.asarray(tok), jnp.int32(12 + i), jc)
        tl, tc = m.port.decode_step(torch.from_numpy(tok), 12 + i, tc)
        outs.append((np.asarray(jl), tl.numpy()))
    j = np.stack([a for a, _ in outs]).astype(np.float64)
    d = np.abs(j - np.stack([b for _, b in outs]))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(j).max())) - 7)
    assert d.max() <= 2 * ulp and np.sqrt((d ** 2).mean()) <= 0.5 * ulp, \
        (d.max() / ulp, np.sqrt((d ** 2).mean()) / ulp)


# ------------------------------------------------------------ the batcher

class _Recording:
    """Wraps a decode step to keep each tick's float32 logits."""

    def __init__(self, fn, to_numpy):
        self.fn, self.to_numpy, self.logits = fn, to_numpy, []

    def __call__(self, *args):
        logits, cache = self.fn(*args)
        self.logits.append(self.to_numpy(logits)[:, 0].astype(np.float64))
        return logits, cache


def _serve_requests(m, requests, n_slots, max_len):
    jb = JWaveBatcher(m.jm, m.params, n_slots=n_slots, max_len=max_len)
    jb._step = _Recording(jb._step, np.asarray)
    ports = []
    for model in (m.port, m.port64):
        b = WaveBatcher(model, n_slots=n_slots, max_len=max_len)
        rec = _Recording(model.decode_step, lambda t: t.numpy())
        b.model = SimpleNamespace(cfg=model.cfg, init_cache=model.init_cache,
                                  decode_step=rec)
        ports.append((b, rec))
    for rid, (prompt, max_new, eos) in enumerate(requests):
        jb.submit(JRequest(rid=rid, prompt=list(prompt), max_new=max_new, eos=eos))
        for b, _ in ports:
            b.submit(Request(rid=rid, prompt=list(prompt), max_new=max_new, eos=eos))
    jdone = {r.rid: r for r in jb.run()}
    (b32, rec32), (b64, rec64) = ports
    tdone = {r.rid: r for r in b32.run()}
    b64.run()
    # Every tick's logits within the anchored bound, and every greedy pick
    # clear of a near tie: then the outputs must be equal.
    assert len(rec32.logits) == len(jb._step.logits) == len(rec64.logits)
    for want, got, anchor in zip(jb._step.logits, rec32.logits, rec64.logits):
        tol = _tol(want, anchor)
        assert np.abs(got - want).max() <= tol
        top2 = np.sort(want, axis=-1)[:, -2:]
        assert ((top2[:, 1] - top2[:, 0]) > 2 * tol).all()
    assert b32.ticks == jb.ticks
    assert sorted(tdone) == sorted(jdone)
    for rid, r in jdone.items():
        assert tdone[rid].out == r.out and tdone[rid].done and r.done
    return jdone


def test_wave_batcher_matches_jax():
    # tests/test_batcher.py:31: 5 requests on 4 slots (2 waves), max_new 6
    m = _models("qwen3-1.7b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m.cfg.vocab, size=L).tolist() for L in (3, 5, 4, 6, 2)]
    done = _serve_requests(m, [(p, 6, None) for p in prompts], n_slots=4, max_len=32)
    assert all(len(r.out) == 6 for r in done.values())


def test_wave_batcher_eos_and_caps_match_jax():
    # tests/test_batcher.py:49: eos, max_new and the max_len cap
    m = _models("qwen2-1.5b", seed=1)
    done = _serve_requests(m, [([1, 2], 4, None), ([3], 50, None)], n_slots=2, max_len=16)
    assert len(done[0].out) == 4 and 0 < len(done[1].out) <= 50
    # an eos that the first request emits: it stops there
    eos = done[0].out[1]
    done = _serve_requests(m, [([1, 2], 4, eos), ([3], 50, None)], n_slots=2, max_len=16)
    assert done[0].out[-1] == eos and len(done[0].out) == 2


# ------------------------------------------------------------- launcher

@pytest.mark.parametrize("extra", [[], ["--window", "8"], ["--temperature", "0.8"]],
                         ids=["greedy", "window", "sampled"])
def test_serve_launcher_runs_on_the_cpu(extra, capsys):
    out = serve.main(["--arch", "qwen3-1.7b", "--batch", "2", "--prompt-len", "6",
                      "--gen", "5", "--device", "cpu", *extra])
    assert out.shape == (2, 5) and out.dtype == torch.int64
    assert int(out.min()) >= 0 and int(out.max()) < tget("qwen3-1.7b").reduced().vocab
    printed = capsys.readouterr().out
    assert "prefill(6 tok x 2)" in printed and "decoded 4 steps x 2 seqs" in printed


def test_token_batches_follow_jax_shapes():
    from repro.data.batches import make_batch as jmake_batch
    from repro_torch.data import make_batch, make_decode_inputs
    cfg = tget("qwen3-1.7b").reduced()
    want = jmake_batch(jget("qwen3-1.7b").reduced(), 3, 7)
    got = make_batch(cfg, 3, 7, generator=torch.Generator().manual_seed(0), device="cpu")
    again = make_batch(cfg, 3, 7, generator=torch.Generator().manual_seed(0), device="cpu")
    assert sorted(got) == sorted(want)
    for key in got:
        assert tuple(got[key].shape) == tuple(want[key].shape) == (3, 7)
        assert torch.equal(got[key], again[key])
    assert torch.equal(got["labels"][:, :-1], got["tokens"][:, 1:])
    assert 0 <= int(got["tokens"].min()) and int(got["tokens"].max()) < cfg.vocab
    tok = make_decode_inputs(cfg, 3, generator=torch.Generator().manual_seed(1),
                             device="cpu")["token"]
    assert tuple(tok.shape) == (3, 1) and int(tok.max()) < cfg.vocab
    with pytest.raises(NotImplementedError):
        make_batch(tget("whisper-medium").reduced(), 1, 4, device="cpu")
