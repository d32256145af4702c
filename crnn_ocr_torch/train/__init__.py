"""Training: the train state and optimizer, the train and eval steps, and
the fit loop."""
