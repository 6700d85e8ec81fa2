"""The plain PyTorch reference the benchmark holds the program to."""
