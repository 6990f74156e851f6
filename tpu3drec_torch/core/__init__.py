"""Core data model, configuration defaults and device policy."""
