"""Training of the port's ``sbl`` workloads: loss, Noam + Adam, the train
step, checkpoints, and the ``Trainer`` entry point (``train_steps`` on top
of it)."""
