"""The threaded executor's server."""
