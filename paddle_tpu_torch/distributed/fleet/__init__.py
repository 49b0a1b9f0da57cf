"""fleet's data side: the MultiSlot generators and the datasets over the
native feed (`paddle_tpu/distributed/fleet/__init__.py`'s exports of
them); `fleet.metrics` is a subpackage."""
from .data_generator import (DataGenerator,  # noqa: F401
                             MultiSlotDataGenerator,
                             MultiSlotStringDataGenerator)
from .dataset import (BoxPSDataset, DatasetBase,  # noqa: F401
                      FileInstantDataset, InMemoryDataset, QueueDataset)
