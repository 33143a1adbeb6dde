"""Build-at-first-use for the port's native code."""
