"""Helpers of the threaded executor's roles."""
