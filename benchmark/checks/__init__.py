"""The comparisons that decide ``correct``."""
