"""Logging and filesystem helpers."""
