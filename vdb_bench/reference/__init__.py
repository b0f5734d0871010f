"""The plain reference that decides ``correct``: plain PyTorch, importing
nothing of the system under test."""
