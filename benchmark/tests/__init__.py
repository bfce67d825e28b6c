"""Tests of the benchmark: on the CPU, and ``cuda``-marked ones for the card."""
