"""Admission scheduler shared by the serving loop."""
