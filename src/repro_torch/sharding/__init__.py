"""Sharding of the port (``repro/sharding``): the client axis
(``sharding.api``); the model axis is ROADMAP.md A18b."""
