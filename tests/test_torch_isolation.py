"""The port stands alone: it imports neither JAX nor the JAX package."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)

# A 2-step CPU slice through the port's public entry points, a tiny
# coded-query server in both modes and with replay, the seeded paths
# (Scheme 2 with the seeded encode, a structure-only decode), Scheme 1 and
# the one-round entry point, and the dense model family (a reduced qwen3:
# prefill, a decode step, the wave batcher); prints the modules of JAX or
# the JAX package that ended up loaded.
_SLICE = """
import json, sys, numpy as np, torch
from repro_torch.core import (FixedCountStragglers, Scheme2, Scheme2Blocked,
                              make_regular_ldpc, run_pgd, second_moment)
from repro_torch.serving import CodedQuery, CodedQueryBatcher
from repro_torch.core.schemes import Uncoded
from repro_torch.data import make_linear_problem
import repro_torch.convert, repro_torch.kernels.build
prob = make_linear_problem(256, 80, seed=0, device="cpu")
code = make_regular_ldpc(20, seed=0)
scheme = Scheme2Blocked.build(code, second_moment(prob.X, prob.y), lr=prob.lr,
                              decode_iters=12)
gen = torch.Generator().manual_seed(0)
res = run_pgd(scheme, torch.zeros(80), FixedCountStragglers(10), 2,
              generator=gen, theta_star=prob.theta_star)
run_pgd(Uncoded(prob.X, prob.y, w=40, lr=prob.lr), torch.zeros(80),
        FixedCountStragglers(10), 2, generator=gen)
small = make_linear_problem(64, 20, seed=0, device="cpu")
served = []
for mode, adaptive in (("continuous", True), ("lockstep", False)):
    s2 = Scheme2.build(code, second_moment(small.X, small.y), lr=small.lr,
                       decode_iters=6, adaptive=adaptive)
    bat = CodedQueryBatcher(s2, n_slots=2, mode=mode, rounds_per_launch=2)
    rng = np.random.default_rng(0)
    for i in range(3):
        bat.submit(CodedQuery(i, rng.standard_normal(20).astype(np.float32),
                              rng.random(40) < 0.3))
    served.append(len(bat.run()))
from repro_torch.core import CodedComputeEngine
from repro_torch.core.ldpc import SeededLDPC, make_seeded_ldgm
seeded = Scheme2.build_seeded(make_seeded_ldgm(20, 10, row_weight=4),
                              second_moment(small.X, small.y), lr=small.lr,
                              decode_iters=6, encode_fused=True)
run_pgd(seeded, torch.zeros(20), FixedCountStragglers(3), 2, generator=gen)
dec = CodedComputeEngine(SeededLDPC(N=64, K=32, l=4, r=8), decode_iters=4).decode(
    torch.ones(64), torch.arange(64) % 5 == 0)
from repro_torch.core import Scheme1
from repro_torch.kernels.ldpc_peel import peel_round_cuda
s1 = Scheme1.build(code, second_moment(prob.X, prob.y), lr=prob.lr)
run_pgd(s1, torch.zeros(80), FixedCountStragglers(10), 2, generator=gen)
peel_round_cuda(torch.as_tensor(code.H, dtype=torch.float32), torch.ones(40, 2),
                torch.arange(40) % 7 == 0)
from repro_torch.core import ScheduleCache
replay = Scheme2.build(code, second_moment(small.X, small.y), lr=small.lr,
                       decode_iters=6, decode_backend="replay",
                       schedule_cache=ScheduleCache())
bat = CodedQueryBatcher(replay, n_slots=2, rounds_per_launch=6)
rng = np.random.default_rng(1)
for i in range(3):
    bat.submit(CodedQuery(i, rng.standard_normal(20).astype(np.float32),
                          rng.random(40) < 0.3))
served.append(len(bat.run()))
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.models import Model
from repro_torch.serving import Request, WaveBatcher
import repro_torch.launch.serve
cfg = get_config("qwen3-1.7b").reduced()
model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
batch = make_batch(cfg, 2, 5, generator=torch.Generator().manual_seed(0), device="cpu")
cache = model.init_cache(2, 8)
logits, cache = model.prefill(batch, cache)
logits, cache = model.decode_step(logits[:, -1].argmax(-1)[:, None], 5, cache)
wave = WaveBatcher(model, n_slots=2, max_len=8)
wave.submit(Request(rid=0, prompt=[1, 2], max_new=3))
served.append(len(wave.run()))
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps({"bad": bad, "errors": res.errors.tolist(), "served": served,
                  "seeded_unresolved": int(dec.erased.sum()),
                  "logits": list(logits.shape), "finite": bool(logits.isfinite().all())}))
"""


def test_slice_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _SLICE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert len(result["errors"]) == 2
    assert result["served"] == [3, 3, 3, 1]
    assert result["seeded_unresolved"] == 0
    assert result["logits"] == [2, 1, 512] and result["finite"]


def _sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _cuda_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("csrc/*.cu*"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_repro(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert hits == []


@pytest.mark.parametrize("path", _cuda_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_cuda_sources_include_only_their_own_headers(path):
    # a CUDA source of the port includes the toolkit's and the standard
    # headers, and its own beside it: nothing of the JAX package
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', path.read_text(), re.M)
    for inc in includes:
        assert not re.match(r"(jax|jaxlib|repro)(/|\.|$)", inc), inc
        assert "/" not in inc and (inc.endswith(".h") or "." not in inc
                                   or (path.parent / inc).is_file()), inc


def test_every_cuda_source_is_built():
    from repro_torch.kernels import build
    sources = {p for p in _cuda_sources() if p.suffix == ".cu"}
    assert sources == {Path(p) for p in build.SOURCES.values()}
    assert "--use_fast_math" not in build.NVCC_FLAGS


@pytest.mark.parametrize("line,forbidden", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jaxlib import xla_client", True), ("import repro", True),
    ("from repro.core import ldpc", True), ("    from repro import obs", True),
    ("import repro_torch", False), ("from repro_torch.core import ldpc", False),
    ("import jaxtyping", False), ("x = 1  # import jax", False),
])
def test_forbidden_pattern(line, forbidden):
    assert bool(FORBIDDEN.search(line)) is forbidden
