"""Serving on the card: concurrent coded gradient queries, and the model
zoo's wave batcher over its KV caches."""
from repro_torch.serving import kvcache
from repro_torch.serving.batcher import Request, WaveBatcher
from repro_torch.serving.coded_queries import CodedQuery, CodedQueryBatcher
from repro_torch.serving.slot_lifecycle import SlotPool

__all__ = ["kvcache", "Request", "WaveBatcher", "CodedQuery", "CodedQueryBatcher",
           "SlotPool"]
