"""Dataset configurations (NumPy)."""
