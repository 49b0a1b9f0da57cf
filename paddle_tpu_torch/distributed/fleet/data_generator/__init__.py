from .data_generator import (DataGenerator, MultiSlotDataGenerator,
                             MultiSlotStringDataGenerator)

__all__ = ['DataGenerator', 'MultiSlotDataGenerator',
           'MultiSlotStringDataGenerator']
