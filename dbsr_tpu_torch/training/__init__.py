"""Training of the port: checkpoints, train state and Adam, actors, the
trainer."""
