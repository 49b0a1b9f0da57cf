"""paddle.hapi — counterpart of `paddle_tpu/hapi`: the high-level
`Model` (prepare / fit / evaluate / predict / save / load), its
callbacks and `summary`."""
from .callbacks import (Callback, EarlyStopping, LRSchedulerCallback,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau,
                        StepTelemetry, VisualDL)
from .model import Model  # noqa: F401
from .summary import summary  # noqa: F401
