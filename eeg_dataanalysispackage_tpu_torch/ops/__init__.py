"""Wavelet operators, device ingest and the CUDA kernels' wrappers."""
