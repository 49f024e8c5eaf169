"""Observability for the port: latency histograms and the SLO block."""
