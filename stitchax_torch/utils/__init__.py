"""Precision helpers for the port."""
