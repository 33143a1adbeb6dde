"""Serving tier of the port: artifacts, the generative engine and
scheduler, and the generate-only HTTP server."""
