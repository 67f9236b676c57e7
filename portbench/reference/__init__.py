"""Plain references that decide ``correct``: plain PyTorch and NumPy, written
from the published descriptions, importing nothing of the port (a test and
``run.py``'s start-up check hold them to that)."""
