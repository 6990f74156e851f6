"""Ported input/output modules: the COLMAP text export (`colmap`) and the
loader half of the inter-stage batch pickles (`batch_pickle`)."""
