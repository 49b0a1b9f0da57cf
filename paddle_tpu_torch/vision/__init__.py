"""paddle.vision — counterpart of `paddle_tpu/vision`: the model zoo
(`models`), the datasets (`datasets`: cached files or the reference's
synthetic sets, never a download) and the numpy transforms
(`transforms`)."""
from . import datasets, models, transforms  # noqa: F401
