"""Per-layer metric learn_ms_per_step.train: `spans.learn_ms_per_step`."""

from benchmark.spans import learn_ms_per_step as read  # noqa: F401
