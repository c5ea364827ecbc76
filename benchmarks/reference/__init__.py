"""The benchmark's plain references: float32 PyTorch and NumPy, importing
nothing of the program."""
