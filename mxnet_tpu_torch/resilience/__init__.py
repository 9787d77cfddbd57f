"""Fault injection and retry policy of the port (stdlib only)."""
