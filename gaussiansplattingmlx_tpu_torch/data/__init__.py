"""Data formats (numpy only)."""
