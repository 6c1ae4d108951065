"""device_idle_pct: 100 x (1 - the union of the device's activity
intervals / the traced window), from torch.profiler's CUDA activity."""

from port_bench.readers import idle_pct as read  # noqa: F401
