"""The plain reference the benchmark holds the program's outputs to:
numpy and torch only, nothing of the program."""
