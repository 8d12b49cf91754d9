"""Exact retrieval core of the port: sparse vectors, spaces, brute-force
top-k, execution backends and the retrieval pipeline."""
