"""Optimizers and LR schedules — counterpart of `paddle_tpu/optimizer`."""
from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, DecayedAdagrad, DGCMomentumOptimizer, Ftrl,
                        Lamb, Lars, LarsMomentum, Momentum, Optimizer,
                        RMSProp)
