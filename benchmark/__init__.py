"""The benchmark of distributedconvrl_pde_control_torch: harness, counts, plain reference."""
