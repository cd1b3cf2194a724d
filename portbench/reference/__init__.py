"""The plain reference of each configuration: plain PyTorch from the
equations, importing nothing of the program under test."""
