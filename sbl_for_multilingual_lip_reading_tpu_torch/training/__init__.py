"""The SBL train step of the port: loss, Noam + Adam, the step, and the
``train_steps`` entry point."""
