"""CPU tests of the benchmark harness (and one test for the card)."""
