"""A run with the timed path broken underneath comes out not correct,
once for each fault the cells can have: half of each batch's answers left
out, and an answer altered where it is produced (negated, or two requests'
answers swapped on their way to their tickets).  The cells run on one
chip, so no exchange between chips can be left out; nothing has a state
that a step could leave unchanged."""
from __future__ import annotations

import pytest

from portbench.harness import run_cell


def _half_left_out(out):
    out = out.copy()
    out[len(out) // 2:] = 0
    return out


def _answer_altered(out):
    out = out.copy()
    out[0] = -out[0]
    return out


def _answers_swapped(out):
    return out[[1, 0, *range(2, len(out))]] if len(out) > 1 else out


FAULTS = {"half_left_out": _half_left_out, "answer_altered": _answer_altered,
          "answers_swapped": _answers_swapped}
CASES = [("tiny.offline", f) for f in FAULTS] + [
    ("tiny.poisson", f) for f in FAULTS] + [("tiny.single", "answer_altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                          fault):
    from repro_torch.api.session import InflightDispatch
    wait = InflightDispatch.wait
    broken = FAULTS[fault]

    def broken_wait(self):
        return broken(wait(self))

    result, _ = run_cell(cell, 97, 0.5, False, device="cpu", root=tiny_root)
    assert result["correct"]
    monkeypatch.setattr(InflightDispatch, "wait", broken_wait)
    result, _ = run_cell(cell, 97, 0.5, False, device="cpu", root=tiny_root)
    assert not result["correct"]
    assert result["checks"]["mean_code_gap"]["value"] > \
        result["checks"]["mean_code_gap"]["limit"]
