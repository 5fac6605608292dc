"""The graph-vs-eager rule (tools/graph_noise.check) on the CPU: a leaf's
L2 distance over its group's scale (the largest leaf norm of the group).
The rule before it divided by the leaf's own norm, so a leaf could be at
most 2 away, and chip_smoke.py's tolerances of the time (OLD_GRAPH_TOL:
mu 2.8, nu 2.1) passed any moment at all. On four eager steps of the small
scene (tools/graph_noise.py "small", f32), the two faults of
graph_noise.mutations: mu's largest leaf negated passes the old rule at
the old tolerance and fails the new rule at the new GRAPH_TOL and at the
small scene's TOL; params' largest leaf left at its seeded value fails the
new rule at the small scene's TOL (at full width its steps move it less
than the eager spread: PERF.md section 2 has the ratio measured on the
card).
"""
import pytest
import torch

from chip_smoke import GRAPH_TOL, TRAINED_TOL
from neuralbody_tpu_torch.tools import graph_noise
from test_torch_graph_cuda import TOL as SMALL_TOL

torch.set_num_threads(1)

# chip_smoke.py's GRAPH_TOL and the small scene's TOL under the old rule
OLD_GRAPH_TOL = {"params": 1.5, "mu": 2.8, "nu": 2.1, "bn": 0.17,
                 "loss": 8.6e-6}
OLD_SMALL_TOL = {"params": 0.034, "mu": 0.081, "nu": 0.035, "bn": 5.8e-4,
                 "loss": 3.7e-7}


def old_over(x, y, tol):
    """The leaves over their group's tolerance under the old rule:
    ||a - b|| / max(||a||, ||b||) per leaf."""
    over = []
    for g in graph_noise.GROUPS:
        for (p, a), (_, b) in zip(x[g], y[g]):
            a, b = a.double(), b.double()
            d = 0.0 if torch.equal(a, b) else (
                (a - b).norm() / torch.maximum(a.norm(), b.norm())).item()
            if d > tol[g]:
                over.append((p, d))
    return over


@pytest.fixture(scope="module")
def states():
    """(seeded state, the state after four eager steps [A, A, B, B])."""
    dev = torch.device("cpu")
    (a, b), settings, init = graph_noise._hat_scene(
        dev, "float32", 64, 500, 0.02, 16, 3, lambda: (lambda t: 5e-4))
    before = graph_noise.run_state(*init(), [])
    after = graph_noise.eager_run(dev, init, [a, a, b, b], settings)
    return before, after


def test_an_equal_run_passes(states):
    _, after = states
    groups, over = graph_noise.check(after, after, GRAPH_TOL)
    assert over == [] and all(v["worst"] == 0 for v in groups.values())


def test_group_distance_is_never_over_the_leaf_distance(states):
    """The group's scale is at least the leaf's own: the new rule reads
    every leaf at most as far as the old one did."""
    before, after = states
    before = dict(before, loss=after["loss"])   # the seeded state has none
    new = graph_noise.distances(after, before)
    for g in graph_noise.GROUPS:
        for (p, d), (_, a), (_, b) in zip(new[g], after[g], before[g]):
            a, b = a.double(), b.double()
            own = (a - b).norm() / max(a.norm(), b.norm(), 1e-300)
            assert d <= own.item() * (1 + 1e-12), p


def test_negated_mu_fails_the_new_rule_only(states):
    before, after = states
    group, path, bad = graph_noise.mutations(after, before)["mu"]
    assert group == "mu"
    # the old rule: the negated leaf is at 2, under mu's 2.8
    assert old_over(bad, after, OLD_GRAPH_TOL) == []
    for tol in (GRAPH_TOL, SMALL_TOL):
        groups, over = graph_noise.check(bad, after, tol)
        assert [p for p, _, _ in over] == [path]
        assert groups["mu"]["path"] == path and groups["mu"]["ratio"] > 100
        assert all(groups[g]["worst"] == 0 for g in graph_noise.GROUPS
                   if g != "mu")


def test_stale_params_fail_the_new_rule(states):
    before, after = states
    group, path, bad = graph_noise.mutations(after, before)["params"]
    assert group == "params"
    assert old_over(bad, after, OLD_SMALL_TOL) == []
    groups, over = graph_noise.check(bad, after, SMALL_TOL)
    assert [p for p, _, _ in over] == [path]
    assert groups["params"]["ratio"] > 1


def test_a_zero_tolerance_reads_zero_or_inf(states):
    """Where the eager runs agree exactly (bf16 on the small scenes) a
    tolerance is 0: an equal leaf reads 0 and any other inf, without a
    division by zero."""
    before, after = states
    zero = dict.fromkeys(graph_noise.GROUPS, 0.0)
    groups, over = graph_noise.check(after, after, zero)
    assert over == [] and all(v["ratio"] == 0 for v in groups.values())
    _, path, bad = graph_noise.mutations(after, before)["mu"]
    groups, over = graph_noise.check(bad, after, zero)
    assert [p for p, _, _ in over] == [path]
    assert groups["mu"]["ratio"] == float("inf")
    assert graph_noise.ratio(0.0, 0.0) == 0.0
    assert graph_noise.ratio(3e-4, 1e-4) == pytest.approx(3.0)


def test_the_trained_state_tolerance(states):
    """chip_smoke.py's TRAINED_TOL (graph_vs_eager_trained: graphed bf16
    steps from a trained checkpoint) passes a state against itself and
    fails it with mu's largest leaf negated; it is looser than GRAPH_TOL
    in every group (trained weights spread eager runs wider), which stays
    as it was."""
    before, after = states
    groups, over = graph_noise.check(after, after, TRAINED_TOL)
    assert over == [] and all(v["ratio"] == 0 for v in groups.values())
    _, path, bad = graph_noise.mutations(after, before)["mu"]
    groups, over = graph_noise.check(bad, after, TRAINED_TOL)
    assert [p for p, _, _ in over] == [path]
    assert groups["mu"]["ratio"] > 1
    assert all(TRAINED_TOL[g] > GRAPH_TOL[g] for g in graph_noise.GROUPS)


@pytest.mark.parametrize("batched", [False, True])
def test_fixed_order_codes_sum_equals_scatter_vertex_codes(batched):
    """tools/graph_noise.py --fixed-sum codes: the vertex codes' segment
    sum equals index_add_'s (on the CPU both add in one order; at f32
    rounding where a row has three addends or more)."""
    from neuralbody_tpu_torch.ops.sparse_conv import scatter_vertex_codes
    g = torch.Generator().manual_seed(0)
    codes = torch.randn(60, 16, generator=g)
    idx = torch.randint(0, 12, (3, 60) if batched else (60,), generator=g)
    torch.testing.assert_close(
        graph_noise.fixed_scatter_vertex_codes(codes, idx, 11),
        scatter_vertex_codes(codes, idx, 11), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fixed_order_hat_backward_equals_the_plain_version(dtype):
    from neuralbody_tpu_torch.ops import hat_kernel
    g = torch.Generator().manual_seed(1)
    sites = torch.randint(0, 8, (20, 3), generator=g).int()
    rows = torch.randint(0, 21, (4, 6), generator=g).int()   # 20: sentinel
    pos = torch.rand(4, 16, 3, generator=g) * 8
    grad = torch.randn(4, 16, 32, generator=g)
    torch.testing.assert_close(
        graph_noise.fixed_hat_bwd(grad, sites, rows, pos, dtype),
        hat_kernel.hat_interp_level_bwd_plain(grad, sites, rows, pos, dtype),
        rtol=1e-6, atol=1e-6)
    assert not torch.are_deterministic_algorithms_enabled()


def test_fixed_sums_swap_the_render_paths_names_and_restore_them():
    from neuralbody_tpu_torch.models import latent_xyzc
    from neuralbody_tpu_torch.ops import hat_interp
    codes, bwd = (latent_xyzc.scatter_vertex_codes,
                  hat_interp.hat_interp_level_bwd)
    with graph_noise.fixed_sums("both"):
        assert latent_xyzc.scatter_vertex_codes is \
            graph_noise.fixed_scatter_vertex_codes
        assert hat_interp.hat_interp_level_bwd is graph_noise.fixed_hat_bwd
    with graph_noise.fixed_sums("hat"):
        assert latent_xyzc.scatter_vertex_codes is codes
    assert (latent_xyzc.scatter_vertex_codes,
            hat_interp.hat_interp_level_bwd) == (codes, bwd)
