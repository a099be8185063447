"""Per-layer metric ksg_solve_roofline.train: `readers_keller_segel.solve_roofline`."""

from benchmark.readers_keller_segel import solve_roofline as read  # noqa: F401
