"""Serving tier of the port: artifacts (export and load), the single-pass
engine, batcher and load generator, the generative engine and scheduler,
and the HTTP server (``/v1/infer`` and ``/v1/generate``)."""
