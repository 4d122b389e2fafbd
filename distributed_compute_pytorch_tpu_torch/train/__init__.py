"""Training on one device: optimizers, the train/eval steps, v1
checkpoints and the trainer loop."""
