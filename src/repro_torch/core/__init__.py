"""The paper's primary contribution: LDPC moment-encoded robust gradient
descent, on PyTorch and CUDA."""
from repro_torch.core.coded_step import RunResult, Scheme2, Scheme2Blocked, run_pgd
from repro_torch.core.decoder import (DecodeResult, PeelSchedule, compile_peel_schedule,
                                      erasure_mask_key, peel_decode, peel_decode_adaptive,
                                      peel_decode_batch, peel_decode_batch_adaptive)
from repro_torch.core.density_evolution import q_final, qd_sequence, threshold
from repro_torch.core.encoding import (Moments, encode_moment,
                                       encode_moment_blocks, second_moment)
from repro_torch.core.engine import CodedComputeEngine, blocked_epilogue
from repro_torch.core.ldpc import LDPCCode, make_parity_only_ldpc, make_regular_ldpc
from repro_torch.core.schedule_cache import ScheduleCache
from repro_torch.core.schemes import Uncoded
from repro_torch.core.straggler import BernoulliStragglers, FixedCountStragglers

__all__ = [
    "LDPCCode", "make_regular_ldpc", "make_parity_only_ldpc",
    "peel_decode", "peel_decode_batch", "peel_decode_adaptive",
    "peel_decode_batch_adaptive", "DecodeResult",
    "PeelSchedule", "compile_peel_schedule", "erasure_mask_key", "ScheduleCache",
    "CodedComputeEngine", "blocked_epilogue",
    "qd_sequence", "q_final", "threshold",
    "Moments", "second_moment", "encode_moment", "encode_moment_blocks",
    "Scheme2", "Scheme2Blocked", "run_pgd", "RunResult", "Uncoded",
    "BernoulliStragglers", "FixedCountStragglers",
]
