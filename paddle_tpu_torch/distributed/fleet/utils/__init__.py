"""fleet.utils — the port's subset of `paddle_tpu/distributed/fleet/utils`:
activation recompute and the remat policies (`recompute.py`)."""
