"""Stage-2 diffusion training: optimizer and state, the train step, the trainer."""
