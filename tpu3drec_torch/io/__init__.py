"""Ported input/output modules: image folders and the native decoder
(`images`, `native_decoder`), the pair checkpoint (`checkpoint`), the
inter-stage batch pickles (`batch_pickle`), result converters
(`converters`) and the COLMAP text export (`colmap`)."""
