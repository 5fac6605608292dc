"""The control fails the check: the plain reference computed on the TF32
tensor cores, the step below the configurations' f32, put against the f32
reference, reads over a limit of every cell (on the card; at a tiny size
here, at the cells' own size in PERF.md)."""
import re

import pytest
import torch

from benchmark.tests.tiny import load_bench, run_tiny

CONTROL = re.compile(r"^control \(the reference in TF32\): (.*)$", re.M)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"]
                                  for w in load_bench()["workloads"]])
def test_control_is_not_correct(monkeypatch, capsys, card, cell):
    out = run_tiny(monkeypatch, cell, seed=11, device=card, control=1)
    assert out["correct"], out["checks"]
    words = CONTROL.search(capsys.readouterr().err).group(1).split()
    read = {k: float(v) for k, v in zip(words[::2], words[1::2])
            if not v.startswith("[")}
    over = {k: (read[k], c["limit"]) for k, c in out["checks"].items()
            if k in read and read[k] > c["limit"]}
    assert over, (read, out["checks"])
