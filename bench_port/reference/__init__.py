"""Plain float32 references of the benchmark's models, in PyTorch alone."""
