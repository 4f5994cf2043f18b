"""File output."""
