"""Datasets and index samplers of the port (numpy and torch only)."""
