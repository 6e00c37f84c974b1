"""The benchmark's own machinery: the manifest and the files it names, the
traffic generator, the reading of the device trace and the layer ranges.

Nothing here imports the program (``repro_torch``) at module level, and
nothing imports ``jax`` or the JAX package.
"""
