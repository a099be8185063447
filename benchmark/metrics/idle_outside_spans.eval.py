"""Per-layer metric idle_outside_spans.eval: `spans.idle_outside_spans`."""

from benchmark.spans import idle_outside_spans as read  # noqa: F401
