"""The split of a stacked dispatch over several devices, and the model's
sharding rules (port of ``repro.distributed``; its GSPMD and ``shard_map``
helpers, ``collectives.py``, stay in the JAX package)."""
