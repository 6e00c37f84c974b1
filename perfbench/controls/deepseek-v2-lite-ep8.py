"""The control of ``deepseek-v2-lite-ep8``, and the faults that the cell's
check has to catch, read on the reference put in the program's place.

* ``control``: the followed steps computed with every product's inputs in
  float8 (e4m3), the precision below the configuration's bfloat16
  compute, against the same steps in float32;
* ``shared_skipped``: each MoE layer without its shared experts;
* ``latent_norm_skipped``: the latent c of each attention layer not
  normalised before its up-projection;
* ``mscale_left_out``: the softmax scale without YaRN's mscale².

Each frees the program's state first, puts the reference so computed in
the program's place (it routes on its own, as a program would, and the
sound reference replays its routing) and returns the numbers the check
compares.
"""

from __future__ import annotations


def _against_reference(runner, **kw) -> dict:
    runner.free()
    got = runner.reference(own_routing=True, **kw)
    return runner.ref.compare(got, runner.reference(routing=got["routing"]))


def control(runner) -> dict:
    return _against_reference(runner, precision="fp8")


def shared_skipped(runner) -> dict:
    return _against_reference(runner, faults=("shared_skipped",))


def latent_norm_skipped(runner) -> dict:
    return _against_reference(runner, faults=("latent_norm_skipped",))


def mscale_left_out(runner) -> dict:
    return _against_reference(runner, faults=("mscale_left_out",))
