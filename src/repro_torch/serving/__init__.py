"""Serving of concurrent coded gradient queries on the card."""
from repro_torch.serving.coded_queries import CodedQuery, CodedQueryBatcher
from repro_torch.serving.slot_lifecycle import SlotPool

__all__ = ["CodedQuery", "CodedQueryBatcher", "SlotPool"]
