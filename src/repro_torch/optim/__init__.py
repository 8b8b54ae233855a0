"""Optimizer substrate of the port: AdamW with float32 masters, learning
rate schedules, gradient compression with error feedback (the port's
``repro.optim``)."""
