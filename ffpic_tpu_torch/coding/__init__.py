"""Entropy coding of the port (the VP8 boolean decoder)."""
