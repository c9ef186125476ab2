"""Utilities: the throughput meter."""
