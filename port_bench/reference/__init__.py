"""Plain references that decide a run's `correct`: the genomes rebuilt from
a graph's JSON (graph.py) and banded alignment scores (align.py). Plain
NumPy and PyTorch: nothing here imports the program under test."""
