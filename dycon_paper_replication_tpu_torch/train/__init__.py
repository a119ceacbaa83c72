"""Training: the train state, the optimizer, the DyCON step and the trainer."""
