"""Observability of a training run: the numerics watchdog."""
