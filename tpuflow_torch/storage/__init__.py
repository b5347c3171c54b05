"""Artifact storage of the port (local directories)."""
