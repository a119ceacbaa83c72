"""Utilities: checkpoints."""
