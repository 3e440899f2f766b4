"""Filter sweeps of the port (one device, local resampling, so far)."""
