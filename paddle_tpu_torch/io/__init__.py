"""Input pipeline — the part of `paddle_tpu/io` the train engines' loop
needs: `DeviceLoader` (device_loader.py), the background prefetch of host
batches onto the card."""
from .device_loader import DeviceLoader

__all__ = ['DeviceLoader']
