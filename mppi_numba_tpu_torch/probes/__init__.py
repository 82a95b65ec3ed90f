"""Hardware probes: small kernels that measure one property of the card."""
