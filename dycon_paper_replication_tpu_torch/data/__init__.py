"""Data: synthetic dataset trees."""
