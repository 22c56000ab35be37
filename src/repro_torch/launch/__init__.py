"""Launch: the step builders (``steps``), the device mesh over
``torch.distributed`` ranks (``mesh``), the specs of a mesh
(``shardings``), the training command line (``train``: ``python -m
repro_torch.launch.train``), and the dry run on a fake group
(``dryrun``) with its cost model (``cost``), roofline (``roofline``) and
profile (``diagnose``)."""
