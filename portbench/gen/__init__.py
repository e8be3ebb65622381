"""Input generation of the port's benchmark (NumPy only)."""
