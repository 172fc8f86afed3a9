"""Optimizers of the substrate (counterpart of ``repro.optim``): AdamW
with optional int8 moments, the LR schedules, top-k compression."""
from . import adamw, compression, schedule
from .adamw import AdamWConfig, QTensor
