"""Training losses: cross-entropy and confidence weighting."""
