"""Shared utilities (tracing, compile cache, CLI)."""
