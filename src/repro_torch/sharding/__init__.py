"""Sharding of the port (``repro/sharding``): the client axis and the
logical axes (``sharding.api``, with the model axis' collectives) and the
parameter partitioning of the model axis (``sharding.partition``)."""
