"""Command-line entry points (counterpart: ``repro.launch``): ``serve``."""
