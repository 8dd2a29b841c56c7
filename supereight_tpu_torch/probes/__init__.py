"""Device probes that time the card's gather paths (`gather_probe`)."""
