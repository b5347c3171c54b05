"""Attention across devices; so far only the single-device oracle."""
