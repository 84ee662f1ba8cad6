"""Dtype policy and performance accounting."""
