"""Traffic: each mix a data file ``<mix>.json`` naming its entry, each
entry a module ``<entry>.py`` (see ``portbench/load.py``)."""
