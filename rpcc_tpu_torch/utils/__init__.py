"""Helpers around the codec: profiling, spans and counters, sizes, headless renderers."""
