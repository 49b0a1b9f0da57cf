"""Optimizers and LR schedules — counterpart of `paddle_tpu/optimizer`."""
from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
