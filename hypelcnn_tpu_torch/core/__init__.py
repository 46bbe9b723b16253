"""Configuration, registries and device selection."""
