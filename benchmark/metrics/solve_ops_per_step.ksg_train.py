"""Per-layer metric solve_ops_per_step.ksg_train: `readers_keller_segel.solve_ops_per_step`."""

from benchmark.readers_keller_segel import solve_ops_per_step as read  # noqa: F401
