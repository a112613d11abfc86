"""Observability of the port: only the counters the engine needs."""
