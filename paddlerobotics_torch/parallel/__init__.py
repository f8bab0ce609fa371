"""Multi-GPU training over ``torch.distributed``: env-axis data parallelism
and model-axis tensor parallelism over a ``DeviceMesh`` (``sharding``), the
rank launcher (``launch``) and the mesh sweep (``dryrun``)."""
