"""Per-particle numerical operations of the port (see the package docstring)."""
