"""Head-only training: losses live in ``ops.losses``; the steps, the
optimizer, checkpoints and the trainer here."""
