"""Training: the optimizer, its schedule and the SemiVL train step."""
