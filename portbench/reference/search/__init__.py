"""Host search of the reference (frozen copies)."""
