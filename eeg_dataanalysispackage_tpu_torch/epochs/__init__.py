"""Epoch metadata: window validity and class balancing."""
