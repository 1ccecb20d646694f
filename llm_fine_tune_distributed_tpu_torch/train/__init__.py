"""SFT training: state, loss, train/eval steps and the trainer."""
