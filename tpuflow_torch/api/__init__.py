"""Public API of the port: the serving ``Predictor``."""
