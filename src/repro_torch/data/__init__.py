"""Data for the host reference path: the seeded synthetic image set and
its federated partitions (``synthetic``)."""
