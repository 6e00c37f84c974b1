"""The cells' checks on the card at a reduced size: a sound run comes out
correct, the solve cell's control (the reference in TF32 in the program's
place) does not.  Marked ``gpu``: they skip without a card.

    python -m pytest -q -m gpu perfbench/tests
"""

import pytest

import run
from harness import files

SOLVE_SMALL = dict(points=100000, data={"kind": "gaussian_mixture", "components": 256, "mean_low": 0.0,
                                        "mean_high": 64.0, "spread": 8.0})
TRAIN_SMALL = dict(num_hidden_layers=2)


def execute(cell, card, **over):
    args = run.parse(["--workload", cell, "--seed", str(2**31 + 4099), "--seconds", "0", "--trace", "0"])
    return run.execute(args, card, **over)


@pytest.mark.gpu
def test_solve_on_the_card(card):
    res = execute("solve-sift1m-k1024-t3", card, cfg_over=SOLVE_SMALL, traffic_over={"k": 128})
    assert res["correct"], res["checks"]
    cfg = {**files.config("sift1m-s10-cyclic4"), **SOLVE_SMALL}
    control = files.load_module(files.BENCH / "controls" / "sift1m-s10-cyclic4.py", "control")
    with control.installed(cfg):
        res = execute("solve-sift1m-k1024-t3", card, cfg_over=SOLVE_SMALL, traffic_over={"k": 128})
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
def test_train_on_the_card(card):
    res = execute("train-qwen3-1.7b-fr4-iid", card, cfg_over=TRAIN_SMALL)
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_tokens_per_s"]["value"] > 0
