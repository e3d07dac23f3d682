"""Phase 8 of chip_smoke.py needs the f32 lowest-row term of its anchor.

Phase 8 holds each served gradient of the coded-query batcher on the
kernel route to the dense backend's within ``1e-4·max|gd| + 4·anchor``
(``chip_smoke.serving_bound``), the anchor the largest distance from the
float64 gradient of the dense gradient and of the query decoded by
``chip_smoke.serving_anchors``' rules.  The float64 rules alone ("lo",
"hi") cannot see f32 rounding amplified along a chain of lowest-row
resolutions, which the kernel's tie-break follows and the dense backend's
does not.  This runs phase 8's traffic on the CPU (its code, problem size,
round budget, slots and query mix; the second batch of 64 of its 320
queries), where the kernel route is the plain version and the encode is
``torch.matmul``: query 76's served gradient is beyond the bound of the
float64 rules, and within the bound with "lo32".
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import Scheme2, make_regular_ldpc, second_moment
from repro_torch.data import make_linear_problem
from repro_torch.serving import CodedQuery, CodedQueryBatcher

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)          # the f32 products' blocking, as measured
    yield mod
    torch.set_num_threads(threads)


def test_phase8_anchor_needs_the_f32_lowest_row_term(chip_smoke):
    K, nq, B, chunk, budget = 1024, 320, 64, 4, 32      # phase 8's
    code = make_regular_ldpc(K, seed=0)
    prob = make_linear_problem(4 * K, K, seed=0, device=torch.device("cpu"))
    mom = second_moment(prob.X, prob.y)
    scheme = Scheme2.build(code, mom, lr=prob.lr, decode_iters=budget, decode_backend="cuda")
    dense = dataclasses.replace(scheme, decode_backend="dense")
    rng = np.random.default_rng(0)
    thetas = rng.standard_normal((nq, K)).astype(np.float32)
    heavy = rng.random(nq) < 0.15
    smasks = rng.random((nq, code.N)) < np.where(heavy, 0.42, 0.08)[:, None]
    first = B                                            # the second batch
    thetas, smasks = thetas[first:first + B], smasks[first:first + B]

    def serve(sch):
        bat = CodedQueryBatcher(sch, n_slots=B, mode="continuous", rounds_per_launch=chunk)
        for i in range(B):
            bat.submit(CodedQuery(i, thetas[i], smasks[i]))
        return sorted(bat.run(), key=lambda q: q.qid)

    g_exact, g64 = chip_smoke.serving_anchors(dense, mom, thetas, smasks, budget, B)
    ratio = {"float64 rules": {}, "all rules": {}}
    for q, w in zip(serve(scheme), serve(dense)):
        g, gd = torch.from_numpy(q.gradient), torch.from_numpy(w.gradient)
        if bool((gd == 0.0).all()):
            continue
        diff = float((g - gd).abs().max())
        for name, rules in (("float64 rules", ("lo", "hi")),
                            ("all rules", chip_smoke.ANCHOR_RULES)):
            bound = chip_smoke.serving_bound(gd, g_exact[q.qid],
                                             [g64[r][q.qid] for r in rules])
            ratio[name][first + q.qid] = diff / bound
    worst = max(ratio["float64 rules"], key=ratio["float64 rules"].get)
    assert ratio["float64 rules"][worst] > 1.0, (worst, ratio["float64 rules"][worst])
    assert max(ratio["all rules"].values()) <= 1.0, ratio["all rules"]
