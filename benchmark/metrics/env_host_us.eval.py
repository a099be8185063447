"""Per-layer metric env_host_us.eval: `spans.env_host_us`."""

from benchmark.spans import env_host_us as read  # noqa: F401
