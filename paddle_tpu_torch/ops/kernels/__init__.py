"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (`_build.py` builds, loads and counts them). Importing the
package registers every kernel's launch counter, so `routes_snapshot()`
always lists them all."""
from . import (fused_elementwise, fused_norm,  # noqa: F401
               fused_optimizer, flash_attention, paged_attention)
from ._build import reset_launches, routes_snapshot  # noqa: F401
