"""Post-processing overlays."""
