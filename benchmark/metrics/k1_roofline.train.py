"""Per-layer metric k1_roofline.train: `readers.k1_roofline`."""

from benchmark.readers import k1_roofline as read  # noqa: F401
