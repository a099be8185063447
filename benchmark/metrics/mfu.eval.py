"""Per-layer metric mfu.eval: `readers.mfu`."""

from benchmark.readers import mfu as read  # noqa: F401
