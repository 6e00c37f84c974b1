"""The control of ``qwen3-1.7b-fr4``, and the faults a training cell can
have, read on the reference put in the program's place.

* ``control``: the followed steps computed with every product's inputs in
  float8 (e4m3), the precision below the configuration's bfloat16 compute,
  against the same steps in float32.
* ``half_batch``: each step's loss taken over half of the shards, their
  mean over that half, against the whole batch.

A state left unchanged reads 1 on ``update_gap`` by the measure itself
and needs no run.  Each function frees the program's state first and
returns the numbers the check compares.
"""

from __future__ import annotations


def _against_reference(runner, **kw) -> dict:
    runner.free()
    want = runner.reference()
    return runner.ref.compare(runner.reference(**kw), want)


def control(runner) -> dict:
    return _against_reference(runner, precision="fp8")


def half_batch(runner) -> dict:
    return _against_reference(runner, half_batch=True)
