"""The multi-process layer and the device plan on the card, at a small size
(tools/dist_check.py's "small" scene: 128 rays x 8 samples, 512
vertices, 4 cm voxels): two ranks on the one card (gloo on CUDA tensors:
NCCL refuses two ranks on one device) against one process, and
plan_hat_device on the card against the same function on the CPU. Skips
where no NVIDIA GPU is present; run on the card with
`python -m pytest --noconftest tests/test_torch_dist_cuda.py -q`.

Tolerances: the ranks bit for bit; the sharded runs against one process
by tools/graph_noise's group distance within TOL, by precision, from
three calls of dist_check at this size on an H100 80GB HBM3 at 700 W
(PERF.md section 2): f32 4x the largest distance (the one-process spread
or the sharded run's, batch mode's the larger here), bf16, deterministic,
2x the larger layout's; ShardedEval within 1e-4 of eval_step's scale (the
render tolerance in f32, 2e-2 in bf16); the plan bit for bit. The faults
dist_check plants must land over TOL: both in f32, the dropped gradient
all_reduce in bf16 (the stale leaf lands at 1.04x bf16's TOL at this
size; chip_smoke.py holds it at full width).
"""
import numpy as np
import pytest
import torch

from neuralbody_tpu_torch.ops import conv_kernel, dense_kernel, hat_kernel
from neuralbody_tpu_torch.tools import dist_check

pytestmark = pytest.mark.cuda

TOL = {"f32": {"params": 4.96e-4, "mu": 2.16e-3, "nu": 1.56e-5,
               "bn": 2.56e-6, "loss": 3.83e-7},
       "bf16": {"params": 5.58e-3, "mu": 3.32e-2, "nu": 1.13e-2,
                "bn": 3.6e-4, "loss": 1.95e-5}}
FAULTS = {"f32": ("stale_leaf", "no_grad_all_reduce"),
          "bf16": ("no_grad_all_reduce",)}
EVAL_TOL = {"f32": 1e-4, "bf16": 2e-2}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    hat_kernel.build()
    conv_kernel.build()
    dense_kernel.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ranks(dev, tmp_path_factory):
    results, _ = dist_check.launch(2, "gloo", "small",
                                   str(tmp_path_factory.mktemp("dist")),
                                   timeout=600)
    return results


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_two_ranks_on_one_card_match_one_process(ranks, mode):
    r0, r1 = ranks
    assert r0["backend"] == "gloo" and r0["device"] == r1["device"]
    a, b = r0["modes"][mode], r1["modes"][mode]
    for k in ("digest", "eval_digest", "batch_digest"):
        assert a[k] == b[k], k
    tol = TOL[mode]
    ratios = {g: (a["vs_single"][g] / tol[g],
                  a["batch_vs_single"][g] / tol[g]) for g in tol}
    faults = {(key, f): max(a[key][f][g] / tol[g] for g in tol)
              for key in ("faults", "batch_faults") for f in FAULTS[mode]}
    print(mode, "ratio_to_TOL", ratios, "spread", a["spread"], "faults",
          faults)
    assert all(max(r) <= 1 for r in ratios.values()), ratios
    assert all(r > 1 for r in faults.values()), faults
    assert a["eval_err"] <= EVAL_TOL[mode]
    assert a["launches"] == {"hat_fwd": 4 * dist_check.STEPS,
                             "hat_bwd": 4 * dist_check.STEPS,
                             "conv": 34 * dist_check.STEPS,
                             "conv_dx": 17 * dist_check.STEPS}


@pytest.mark.parametrize("rowcum", [True, False],
                         ids=["rowcum", "searchsorted"])
def test_device_plan_on_the_card_matches_the_cpu(dev, rowcum):
    from neuralbody_tpu_torch.ops.device_plan import (DevicePlanSpec,
                                                      plan_hat_device)
    from neuralbody_tpu_torch.ops.hat_interp import prepare_hat_batch
    from neuralbody_tpu_torch.utils.platform import to_device
    from neuralbody_tpu_torch.utils.synthetic import make_batch
    rays, st = make_batch(n_rays=256, n_verts=512, voxel_size=0.02, seed=3)
    hat, hs = prepare_hat_batch(rays, st["out_sh"], st["site_caps"],
                                (0.02,) * 3, 16, group_size=32, d_spans=True)
    spec = DevicePlanSpec(
        out_sh=tuple(st["out_sh"]), site_caps=tuple(st["site_caps"]),
        group_size=32, tile=(4, 8), n_groups=hs["n_groups"],
        rows_caps=tuple(hs["rows_caps"]), seg_caps=tuple(hs["d_spans"]))
    pts = (rays["ray_o"][0][:, None, :] + rays["ray_d"][0][:, None, :]
           * hat["z_vals"][0][..., None]).reshape(-1, 3)
    dhw = (((pts - rays["Th"][0].reshape(1, 3)) @ rays["R"][0])[:, [2, 1, 0]]
           - rays["bounds"][0][0][[2, 1, 0]]) / np.float32(0.02)
    dhw = torch.from_numpy(dhw.astype(np.float32))
    geom = {k: v[0] for k, v in rays["geom"].items()
            if rowcum or not k.startswith("rowcum")}
    cpu = plan_hat_device(dhw, to_device(geom, "cpu"), spec)
    card = plan_hat_device(dhw.to(dev), to_device(geom, dev), spec)
    assert float(cpu[2]) == float(card[2]) == 0.0
    assert torch.equal(cpu[0], card[0].cpu())
    for lvl in (1, 2, 3, 4):
        assert torch.equal(cpu[1][lvl], card[1][lvl].cpu()), lvl
