"""Data: the seeded synthetic image set and its federated partitions for
the host reference path (``synthetic``), and the synthetic LM token
streams of the transformer task (``tokens``)."""
