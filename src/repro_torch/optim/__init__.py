"""Coordinate-space optimizers and the subspace optimizer."""
