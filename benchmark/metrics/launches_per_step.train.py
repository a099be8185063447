"""Per-layer metric launches_per_step.train: `readers.launches_per_step`."""

from benchmark.readers import launches_per_step as read  # noqa: F401
