"""The isweep loop (cell packed.sweep) on the CPU at a quarter-size frame:
a sound run is `correct`; a run whose answers go to the check with the
last chunk's prior in place of the one that scored them reads a larger
`lcp_gap`, over the cell's limit; and a program that names no such prior
stops the run in set-up, before any request."""

import pytest
import torch

import run
from test_bench_harness import TINY_LIMITS, tiny_spec

SEED = 2**31 + 43


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_isweep():
    """The cell at tiny_spec's size, with 64-base sweeps in chunks of 16,
    the cell's numbers under tiny_spec's limits (a quarter-size frame's
    sound `lcp_gap` can read over the cell's own limit), and a box of 6,000 source points, whose plain preprocessing (O(n^2)
    normals) takes seconds on the CPU where the cell's 30,000 take
    minutes."""
    spec = tiny_spec("packed.sweep")
    spec["traffic"].update(bases=64, chunk=16)
    spec["config"]["scene"].update(source_points=6000)
    cell = run.load_spec("packed.sweep")["cell"]["limits"]
    spec["cell"]["limits"] = {k: TINY_LIMITS[k] for k in cell}
    return spec


@pytest.fixture(scope="module")
def sound():
    """A sound traced run and what it printed to stderr."""
    import contextlib
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = run.execute(tiny_isweep(), SEED, 0.1, 1, device="cpu", scale=0.25)
    return out, err.getvalue()


def test_the_isweep_loop_is_correct(sound):
    out, err = sound
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "isweep: answers by best chunk:" in err
    layer = out["metrics"]
    assert set(layer) == {"sample_ms.isweep", "phases_ms.isweep"}
    assert layer["sample_ms.isweep"]["value"] > 0 and layer["phases_ms.isweep"]["value"] > 0


def test_the_last_chunks_prior_reads_over_the_limit(sound, monkeypatch):
    from model_matching_tpu_torch.estimator import StocsEstimator

    cell = run.load_spec("packed.sweep")["cell"]["limits"]["lcp_gap"]
    sweep = StocsEstimator.run_sweep

    def handing_the_last_prior(self, *a, **kw):
        out = sweep(self, *a, **kw)
        self.best_prior = self.class_prob
        return out

    monkeypatch.setattr(StocsEstimator, "run_sweep", handing_the_last_prior)
    out = run.execute(tiny_isweep(), SEED, 0.1, 0, device="cpu", scale=0.25)
    assert out["correct"] is False and out["failed"] == 0
    gap, was = out["checks"]["lcp_gap"], sound[0]["checks"]["lcp_gap"]
    assert gap["value"] > max(gap["limit"], cell) and gap["limit"] > was["value"], (
        out["checks"], was)


def test_a_program_that_names_no_prior_stops_in_set_up(monkeypatch):
    from model_matching_tpu_torch.estimator import StocsEstimator

    init = StocsEstimator.__init__

    def without_the_prior(self, *a, **kw):
        init(self, *a, **kw)
        del self.best_prior

    monkeypatch.setattr(StocsEstimator, "__init__", without_the_prior)
    sweep = StocsEstimator.run_sweep
    calls = []
    monkeypatch.setattr(StocsEstimator, "run_sweep",
                        lambda self, *a, **kw: calls.append(1) or sweep(self, *a, **kw))
    with pytest.raises(SystemExit, match="isweep: the program does not name the prior"):
        run.execute(tiny_isweep(), SEED, 30.0, 0, device="cpu", scale=0.25)
    assert not calls
