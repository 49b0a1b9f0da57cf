"""paddle_tpu_torch.distributed — the sparse-table entry policies and
the fleet datasets (`paddle_tpu/distributed/__init__.py:25-27`). The
collective API is not ported yet (ROADMAP Queue 1 item 7)."""
from .entry_attr import (CountFilterEntry, EntryAttr,  # noqa: F401
                         ProbabilityEntry)
from .fleet.dataset import InMemoryDataset, QueueDataset  # noqa: F401
