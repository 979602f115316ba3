"""Observability: named records and the metrics surface."""
