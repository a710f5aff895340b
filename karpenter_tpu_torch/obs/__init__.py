"""Observability of the port: the telemetry wire (``telemetry_words``)."""
