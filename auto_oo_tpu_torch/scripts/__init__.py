"""Entry points of the port that are run as ``python -m``."""
