"""The plain references that decide ``correct``: plain PyTorch and NumPy,
importing nothing of the program under test."""
