"""Host-side parameter server (reference: paddle/fluid/distributed): the
wire (`service.py`), the async communicator and the server runtime."""
from .communicator import AsyncCommunicator  # noqa: F401
