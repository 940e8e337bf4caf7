"""Logical-axis sharding rules and the collectives of the port's mesh
layout (``repro.distributed``)."""
