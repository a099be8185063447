"""Plain PyTorch references of the benchmark's configurations: no kernel, cache or batching
of the program, and nothing imported from it."""
