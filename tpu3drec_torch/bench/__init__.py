"""Ported benchmark inputs: the synthetic SfM folder (`synthetic`)."""
