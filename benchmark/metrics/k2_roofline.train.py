"""Per-layer metric k2_roofline.train: `readers.k2_roofline`."""

from benchmark.readers import k2_roofline as read  # noqa: F401
