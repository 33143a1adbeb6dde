"""Serving tier of the port: artifacts (export and load), the single-pass
engine (hot swap, shadow engines), batcher and load generators, the
generative engine and scheduler, the HTTP server (``/v1/infer``,
``/v1/generate``, ``/v1/admin/swap``), the model registry, the canary
router and the replicated frontend."""
