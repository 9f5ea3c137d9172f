"""The scenes, one module each, found by name."""
