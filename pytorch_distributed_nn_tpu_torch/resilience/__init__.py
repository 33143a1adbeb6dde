"""Resilience of the port's training runs: retried host I/O
(:mod:`.retry`), and signal handling, heartbeat and validated resume
(:mod:`.supervisor`)."""
