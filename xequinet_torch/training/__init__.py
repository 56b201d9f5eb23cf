"""Training of the port: loss and metrics, schedules and optimizers, the
Trainer."""
