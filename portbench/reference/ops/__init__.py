"""Host kernels of the reference (frozen copies)."""
