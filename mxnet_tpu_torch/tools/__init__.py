"""Command-line tools of the port (the counterparts of ``tools/``)."""
