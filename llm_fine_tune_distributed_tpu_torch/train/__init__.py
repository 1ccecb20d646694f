"""SFT training: state, loss, train/eval steps, the trainer, its checkpoints
and the publish of its weights for live deployment."""
