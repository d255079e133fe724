"""Observability of the port: host-side latency summaries."""
