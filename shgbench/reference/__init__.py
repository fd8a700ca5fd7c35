"""Plain references of the benchmark's configurations (numpy and scipy;
nothing of the program)."""
