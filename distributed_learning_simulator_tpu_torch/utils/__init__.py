"""Logging, device resolution and client selection."""
