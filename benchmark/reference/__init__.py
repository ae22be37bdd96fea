"""Plain references in PyTorch: they import nothing of the program and take
only the inputs the benchmark made."""
