"""The trainer: its entry point, the train step, the one-card mesh and
fault tolerance."""
