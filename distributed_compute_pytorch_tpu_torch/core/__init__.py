"""Run configuration."""
