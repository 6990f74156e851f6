"""Ported pipelines: folder matching (`matching`) and dense
reconstruction (`dense`)."""
