"""Data parallelism over ``torch.distributed`` (counterpart of
``etmppo_tpu/parallel/``): ``mesh.py`` (the ranks of one run, their
collectives, ``spawn``), ``multihost.py`` (process-group initialisation
across hosts, torchrun's environment) and ``probe.py`` (rank functions that
return what a check of a data-parallel run needs)."""
