"""Utilities: checkpoints, the experiment logger, step timing and the
similarity monitor."""
