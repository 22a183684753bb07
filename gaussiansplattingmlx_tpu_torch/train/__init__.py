"""Training: Adam and the train step / loop (torch)."""
