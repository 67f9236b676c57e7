"""Serve-step factories (the port's ``repro.training``); the training step
comes with the training slice (ROADMAP Queue 1 item 14)."""
