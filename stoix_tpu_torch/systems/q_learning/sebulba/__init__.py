"""Sebulba value-based systems."""
