"""Render engine: scene prep, the march and its epilogue."""
