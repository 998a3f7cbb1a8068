"""Parallelism over ``torch.distributed`` (counterpart of
cognitive_aim_tpu/parallel/): differentiable collectives (``comm``), the
data- and tensor-parallel sharding rules (``sharding``) and the GPipe
pipeline (``pipeline``). Importing them starts no process group."""
