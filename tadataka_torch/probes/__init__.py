"""Hopper counterparts of the Pallas probes under ``benchmarks/``: kernels
that measure the card's floors for the main path's kernels."""
