"""Build helpers and device selection."""
