"""The plain float32 reference the benchmark judges the program by:
PyTorch only, importing nothing of the program (frozen copies of its
plain code where noted)."""
