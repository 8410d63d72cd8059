"""The threaded executor's workers."""
