"""Training stack: LR schedules, optimizers, checkpointing, the Trainer."""
