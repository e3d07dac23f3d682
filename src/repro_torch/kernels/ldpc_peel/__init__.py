"""LDPC peeling decode on the card: the fixed-D and early-exit flooding
decodes, for one pattern or a batch, over a code's neighbour table or
regenerated from a seeded code's seed; the straight-line replay of
pre-solved peeling schedules; and the seeded-LDGM encode."""
from repro_torch.kernels.ldpc_peel.ops import (CodeTables, ReplayPack,
                                               encode_seeded_fused_cuda,
                                               peel_decode_adaptive_cuda,
                                               peel_decode_adaptive_seeded_cuda,
                                               peel_decode_batch_adaptive_cuda,
                                               peel_decode_batch_adaptive_seeded_cuda,
                                               peel_decode_batch_cuda,
                                               peel_decode_batch_seeded_cuda,
                                               peel_decode_cuda, peel_decode_replay_cuda,
                                               peel_decode_seeded_cuda)
from repro_torch.kernels.ldpc_peel.ref import (decode_fused_adaptive_ref,
                                               decode_fused_batch_adaptive_ref,
                                               decode_fused_batch_ref, decode_fused_ref,
                                               decode_seeded_adaptive_ref,
                                               decode_seeded_batch_adaptive_ref,
                                               decode_seeded_batch_ref, decode_seeded_ref,
                                               decode_table_adaptive_ref,
                                               decode_table_batch_adaptive_ref,
                                               decode_table_batch_ref, decode_table_ref,
                                               dense_h, encode_seeded_ref, replay_ref)

__all__ = ["CodeTables", "ReplayPack", "peel_decode_cuda", "peel_decode_batch_cuda",
           "peel_decode_adaptive_cuda", "peel_decode_batch_adaptive_cuda",
           "peel_decode_seeded_cuda", "peel_decode_batch_seeded_cuda",
           "peel_decode_adaptive_seeded_cuda", "peel_decode_batch_adaptive_seeded_cuda",
           "encode_seeded_fused_cuda", "peel_decode_replay_cuda",
           "decode_fused_ref", "decode_fused_batch_ref", "decode_fused_adaptive_ref",
           "decode_fused_batch_adaptive_ref", "dense_h",
           "decode_table_ref", "decode_table_batch_ref", "decode_table_adaptive_ref",
           "decode_table_batch_adaptive_ref",
           "decode_seeded_ref", "decode_seeded_batch_ref", "decode_seeded_adaptive_ref",
           "decode_seeded_batch_adaptive_ref", "encode_seeded_ref", "replay_ref"]
