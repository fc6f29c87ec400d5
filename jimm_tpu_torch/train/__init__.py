"""Training: losses, the optimizer and train step, metrics."""
