"""Telemetry of the port's runs (training steps and events, served
requests) and request tracing of its serving path."""
