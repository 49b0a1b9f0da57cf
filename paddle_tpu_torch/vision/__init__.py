"""paddle.vision — counterpart of `paddle_tpu/vision`: the model zoo
(`models`). `datasets` (which downloads) and `transforms` are not
ported; the bench's vision legs feed random images."""
from . import models  # noqa: F401
