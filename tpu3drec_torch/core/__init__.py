"""Core data model, configuration presets, the matcher registry,
multi-method match merging and device policy."""
