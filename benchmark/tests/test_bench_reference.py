"""The plain reference against the port's plain paths at a tiny size on the
CPU (this test may import both; the reference imports nothing of the
port): the pieces one by one, then every cell of BENCHMARK.json end to end
through its loop, whose check compares the reference with what the port
produced."""
import pytest
import torch

from benchmark.reference import common
from benchmark.tests.tiny import load_bench, run_tiny


def test_pieces_match_the_port():
    from neuralbody_tpu_torch.ops.compositing import raw2outputs
    from neuralbody_tpu_torch.ops.embedder import positional_encoding
    from neuralbody_tpu_torch.ops.sample_pdf import sample_pdf
    g = torch.Generator().manual_seed(0)
    x = torch.randn((50, 3), generator=g)
    assert torch.equal(common.positional_encoding(x, 4),
                       positional_encoding(x, 4))
    raw = torch.randn((50, 16, 4), generator=g)
    z = torch.sort(torch.rand((50, 16), generator=g) * 3 + 1, -1).values
    rgb, w = common.composite(raw, z, x)
    ret = raw2outputs(raw, z, x)
    assert torch.allclose(rgb, ret["rgb_map"], atol=1e-6)
    assert torch.allclose(w, ret["weights"], atol=1e-6)
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    assert torch.allclose(common.importance_depths(mid, w[:, 1:-1], 32),
                          sample_pdf(mid, w[:, 1:-1], 32, det=True),
                          atol=1e-6)


@pytest.mark.parametrize("cell", [w["name"]
                                  for w in load_bench()["workloads"]])
def test_cell_agrees_at_a_tiny_size(monkeypatch, cell):
    torch.set_num_threads(2)
    out = run_tiny(monkeypatch, cell, seed=5)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0

