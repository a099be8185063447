"""Per-layer metric solve_host_us.eval: `spans.solve_host_us`."""

from benchmark.spans import solve_host_us as read  # noqa: F401
