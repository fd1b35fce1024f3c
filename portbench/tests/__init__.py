"""CPU tests of the benchmark harness (card-only tests are marked ``cuda``)."""
