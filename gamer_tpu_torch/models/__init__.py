"""Parametric galaxy families."""
