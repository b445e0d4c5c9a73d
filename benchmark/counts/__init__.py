"""Operation and byte counts behind the rooflines and `mfu`, worked out from a configuration's widths."""
