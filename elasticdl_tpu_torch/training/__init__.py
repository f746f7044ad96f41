"""Training: step builders and the mixed-precision policy."""
