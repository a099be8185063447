"""Per-layer metric mfu.train: `readers.mfu`."""

from benchmark.readers import mfu as read  # noqa: F401
