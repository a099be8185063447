"""Per-layer metric device_idle_share.train: `readers.idle_share`."""

from benchmark.readers import idle_share as read  # noqa: F401
