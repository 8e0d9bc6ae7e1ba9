"""Wire-level types of the port (errors only, in this slice)."""
