"""Command-line entry points (counterpart: ``repro.launch``): ``serve``,
``train`` and the meshes of ``mesh``."""
