"""The results driver."""
