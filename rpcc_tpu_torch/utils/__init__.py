"""Helpers around the codec (profiling)."""
