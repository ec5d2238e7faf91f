"""Utilities: device selection, logging and synthetic matrices."""
