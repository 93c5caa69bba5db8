"""Training runtime of the port: losses, metrics, schedules, the optimizer
builder, checkpoints and ``train()``."""
