"""Telemetry of the port's runs (training steps and events, served
requests), request tracing, the stream reader, SLOs, the Prometheus
exposition and the ``obs`` tools."""
