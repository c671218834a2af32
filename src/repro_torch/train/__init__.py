"""Step bundles of the port (``train/steps.py``)."""
