"""Per-layer metric mfu.ksg_train: `readers_keller_segel.mfu`."""

from benchmark.readers_keller_segel import mfu as read  # noqa: F401
