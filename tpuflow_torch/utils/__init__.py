"""Host utilities of the port (local paths only)."""
