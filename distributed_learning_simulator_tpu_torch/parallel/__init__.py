"""Round sessions of the port (one device, clients as a chunked loop)."""
