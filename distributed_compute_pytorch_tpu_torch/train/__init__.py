"""Training: optimizers over one flat layout, the train/eval steps
(replicated, ZeRO-1 or FSDP over ranks), v1 checkpoints and the trainer
loop."""
