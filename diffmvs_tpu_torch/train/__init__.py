"""Training: schedules, optimizer state, the step, checkpoints, the loop."""
