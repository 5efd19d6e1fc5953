"""Multi-device execution: the (dcn, dp, tp) mesh and the limb-sharded
layer step over ``torch.distributed`` (``sharding.py``)."""
