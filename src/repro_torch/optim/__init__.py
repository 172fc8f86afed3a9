"""Optimizers of the substrate (counterpart of ``repro.optim``); so far
only ``AdamWConfig``."""
from . import adamw
from .adamw import AdamWConfig
