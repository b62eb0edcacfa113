"""The plain reference: a proof computed anew in plain PyTorch, sharing nothing with the measured program."""
