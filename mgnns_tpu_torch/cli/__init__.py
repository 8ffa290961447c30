"""Command-line entry points: ``main`` (training) and ``prepare`` (data)."""
