"""Training: schedules, the train step, checkpoints and the trainer."""
