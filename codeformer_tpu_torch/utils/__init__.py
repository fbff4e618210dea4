"""Checkpoint conversion and registries."""
