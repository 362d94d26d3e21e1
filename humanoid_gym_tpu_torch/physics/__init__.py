"""Batched rigid-body physics for the PyTorch port (see the package docstring)."""
