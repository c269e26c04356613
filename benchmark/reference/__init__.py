"""The plain PyTorch reference of the benchmark's configurations."""
