"""Per-layer metric act_host_us.eval: `spans.act_host_us`."""

from benchmark.spans import act_host_us as read  # noqa: F401
