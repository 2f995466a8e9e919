"""The benchmark's harness: cells found by name, seeded weights and
traffic, the traced run's reduction, and the correctness check."""
