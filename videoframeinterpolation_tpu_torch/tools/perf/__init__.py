"""Probes of single kernels on the card (counterparts of ``tools/perf``'s Pallas probes)."""
