"""Launch layer of the port: meshes of ``torch.distributed`` ranks, the
sharding rules, the collectives, the launchers, the op-level count, the
roofline on H100 terms and the multi-pod dry run (``dryrun``, rendered by
``make_tables``).

The reference's ``launch/compat.py`` has no twin file: it shims JAX APIs
that moved between jax versions (``shard_map``, mesh axis types), and the
port calls no JAX.  Its ``hlo_analysis.py`` is ``op_analysis.py`` here.
"""
