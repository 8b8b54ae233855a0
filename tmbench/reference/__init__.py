"""The benchmark's plain reference of the Tsetlin Machine (``tm.py``):
plain PyTorch, independent of the program under test."""
