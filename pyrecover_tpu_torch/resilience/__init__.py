"""Checkpoint I/O resilience: transient-error retry and quarantine."""
