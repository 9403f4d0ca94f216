"""Inference engines (test), and training: the train step and loop
(train), the optimizer and lr schedule (optimizer), checkpoints
(checkpoint)."""
