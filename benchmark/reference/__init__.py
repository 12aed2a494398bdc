"""The plain reference that decides ``correct``: float32 PyTorch with no
kernel, importing nothing of the program (frozen copies of the port's plain
versions, kept here so that a change to the program cannot move them)."""
