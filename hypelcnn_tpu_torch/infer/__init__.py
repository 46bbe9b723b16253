"""Full-scene and per-target inference."""
