"""Helpers around the codec: profiling, stage timers and traces, sizes, headless renderers."""
