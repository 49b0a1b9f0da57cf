"""Optimizers — counterpart of `paddle_tpu/optimizer`."""
from .optimizer import SGD, Adam, AdamW, Optimizer  # noqa: F401
