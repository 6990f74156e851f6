"""Ported pipelines: dense reconstruction (`dense`)."""
