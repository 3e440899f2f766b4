"""Model descriptions of the port."""
