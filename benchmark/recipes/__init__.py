"""Frozen copies of the data recipes the configurations name."""
