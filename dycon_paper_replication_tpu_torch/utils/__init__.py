"""Utilities: checkpoints and the experiment logger."""
