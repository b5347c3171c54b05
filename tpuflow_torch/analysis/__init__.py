"""Static checks of the port (serving sidecars)."""
