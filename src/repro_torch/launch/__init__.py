"""Launch: the step builders (``steps``), the device mesh over
``torch.distributed`` ranks (``mesh``) and the training command line
(``train``: ``python -m repro_torch.launch.train``)."""
