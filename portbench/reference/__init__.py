"""The benchmark's plain reference: plain PyTorch and NumPy, importing
nothing of the program under test."""
