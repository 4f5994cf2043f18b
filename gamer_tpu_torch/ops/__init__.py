"""Torch math: 3-D helpers, camera, simplex noise."""
