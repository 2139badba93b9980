"""The check fails what it has to, through the harness's own run and verdict
(`run.execute`, the look for a card skipped, a quarter-size frame on the
CPU): the bfloat16 control in the program's place, and runs whose timed
path is broken underneath (benchmark/faults.py): an answer altered where
it is produced, half of the scene left out, a step that hands back its
first answer, and the ICP polish left out."""

import pytest
import torch

import run
from test_bench_harness import tiny_spec

SEED = 2**31 + 21


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["ycb.serve", "packed.serve"])
def test_the_control_fails_the_limits(cell):
    out = run.execute(tiny_spec(cell), SEED, 0.1, 0, device="cpu", scale=0.25,
                      program="control")
    assert out["attempted"] >= 1 and out["correct"] is False, out["checks"]
    c = out["checks"]["scene_miss"]
    assert c["value"] > 10 * c["limit"], out["checks"]


def test_an_unbroken_run_is_correct():
    out = run.execute(tiny_spec("ycb.serve"), SEED, 0.1, 0, device="cpu", scale=0.25)
    assert out["correct"] is True, out["checks"]


# the stale answer needs a window of both frames: the first repeats the
# warm-up's frame
@pytest.mark.parametrize("fault,numbers,seconds", [
    ("answer_moved", ("lcp_gap", "adds_mm", "lcp_short"), 0.1),
    ("half_scene", ("scene_miss",), 0.1),
    ("stale_state", ("adds_mm", "lcp_short"), 6.0),
    ("icp_skipped", ("lcp_short",), 0.1)],
    ids=["answer_altered", "half_left_out", "state_unchanged", "icp_left_out"])
def test_a_broken_run_is_not_correct(fault, numbers, seconds):
    out = run.execute(tiny_spec("ycb.serve"), SEED, seconds, 0, device="cpu", scale=0.25,
                      program=fault)
    assert out["attempted"] >= (2 if seconds > 1 else 1)
    assert out["correct"] is False
    for number in numbers:
        c = out["checks"][number]
        assert c["value"] > c["limit"], (number, out["checks"])
