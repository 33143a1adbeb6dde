"""Telemetry and request tracing of the port's serving path."""
