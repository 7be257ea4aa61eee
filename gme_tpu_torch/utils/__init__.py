"""Tracing and timing utilities."""
