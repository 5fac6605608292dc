"""The port's multi-process layer (neuralbody_tpu_torch/parallel/:
bootstrap, mesh, collectives, train) on the CPU: two gloo ranks against the
JAX package's sharded steps on a 2-device mesh of tests/conftest.py's 8
virtual devices, at tests/test_parallel.py's size (128 rays, 512 vertices,
4 cm voxels, 8 samples).

One spawn of two processes (this file run as a script, NB_COORDINATOR on a
free port) runs every case and writes each rank's results to an .npz; the
tests compare them with JAX here. Cases: the plan-free step in rays mode,
the hat step with group sharding, ShardedEval of a rays-only and a hat
batch, batch mode over two frames (the BatchNorm synced over the ranks;
the same step with a per-rank BatchNorm is recorded too and must miss),
the device plan under group sharding, a G = 2 scan, one NeRF step, and the
Trainer on a fake ZJU tree (rank 0 alone writes the checkpoint).

Tolerances, and why: the JAX ones of tests/test_parallel.py:58-65 (loss
rtol 1e-5; parameters and BatchNorm stats rtol 5e-4 / atol 5e-5 after one
Adam step at lr 5e-4) and :86-91 for the eval maps (rtol 1e-5 / atol
1e-6): the port's sums run in another order. Against JAX the parameters
are held leaf by leaf (_params_close): an element whose gradient is small
for its leaf can take the other sign in the other package, and Adam moves
it lr the other way (measured in the plain and hat steps: 16 of 69 leaves
have such elements, at most 0.56% of a leaf, one of a BatchNorm scale's
16, each with a JAX gradient under 3.3% of its leaf's largest; none in
batch mode). Against the port's own one-process step every element holds
PARAM_TOL. Between the two ranks: bit for bit (every gradient is
all-reduced before the update, BatchNorm stats are broadcast or synced).
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LR = 5e-4
VOX = 0.04
N_RAYS = 128
N_SAMPLES = 8
R_PER = 64          # rays a frame in the batch-mode scene
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
EVAL_TOL = dict(rtol=1e-5, atol=1e-6)
MISS_SHARE = 0.01   # of a leaf, against JAX: measured up to 0.56%
NEAR_ZERO = 0.05    # |g| / the leaf's largest at a miss: measured to 0.033
DEADLINE_S = 240


# -- the spawned ranks --------------------------------------------------------


def _worker(inp, out):
    """Run every case as this rank; write its results to `out`."""
    import torch

    from neuralbody_tpu_torch.models import latent_xyzc as lx
    from neuralbody_tpu_torch.models import nerf
    from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
    from neuralbody_tpu_torch.ops.device_plan import DevicePlanSpec
    from neuralbody_tpu_torch.parallel import bootstrap, mesh
    from neuralbody_tpu_torch.parallel import train as ptrain
    from neuralbody_tpu_torch.renderer.renderer import RenderSettings
    from neuralbody_tpu_torch.renderer.volume_renderer import \
        NerfRenderSettings
    from neuralbody_tpu_torch.train import step as tstep
    from neuralbody_tpu_torch.train.fresh import stack_batches
    from neuralbody_tpu_torch.train.optimizer import Adam, tree_leaves
    from neuralbody_tpu_torch.utils.transplant import params_from_jax

    torch.set_num_threads(1)
    assert bootstrap.maybe_initialize_distributed(device="cpu")
    assert bootstrap.maybe_initialize_distributed(device="cpu")  # twice
    rank, world = bootstrap.rank(), bootstrap.world()
    assert world == WORLD and bootstrap.is_primary() == (rank == 0)
    with open(inp, "rb") as f:
        data = pickle.load(f)
    st = data["static"]
    ms = lx.ModelStatic(encoder=EncoderStatic(out_sh=st["out_sh"],
                                              site_caps=st["site_caps"]))
    settings = RenderSettings(model=ms, voxel_size=(VOX,) * 3,
                              n_samples=N_SAMPLES, chunk_rays=N_RAYS,
                              perturb=False)
    res = {}

    def fresh_state(params=None):
        p, bn = params_from_jax(*(params or data["weights"]))
        return p, bn, Adam(p, lambda t: LR)

    def save(case, params, bn, stats):
        for i, x in enumerate(tree_leaves(params)):
            res[f"{case}/p{i}"] = x.detach().numpy()
        for i, x in enumerate(tree_leaves(bn)):
            res[f"{case}/bn{i}"] = x.detach().numpy()
        for k, v in stats.items():
            res[f"{case}/{k}"] = v.detach().numpy()

    def step(case, batch, s, mode="rays"):
        p, bn, opt = fresh_state()
        bn, stats = ptrain.sharded_step(p, bn, opt, batch, s, mode,
                                        device="cpu")
        save(case, p, bn, stats)
        if rank == 0:      # the port's one-process step on the whole batch
            p, bn, opt = fresh_state()
            bn, stats = tstep.train_step(p, bn, opt, batch, s, device="cpu")
            save(f"{case}_single", p, bn, stats)

    step("plain", data["plain"], settings)
    s_hat = settings._replace(hat_rows_caps=tuple(data["rows_caps"]))
    step("hat", data["hat"], s_hat)
    step("device_plan", data["plain"],
         settings._replace(hat_plan=DevicePlanSpec(**data["spec"])))

    p, _, _ = fresh_state()
    for case, batch, s in (("eval", data["plain"], settings),
                           ("eval_hat", data["hat"], s_hat)):
        ret = ptrain.ShardedEval(s, "cpu")(p, batch)
        for k, v in ret.items():
            res[f"{case}/{k}"] = v.numpy()

    local = mesh.shard_batch(data["frames"], rank, world, mode="batch")
    p, bn, opt = fresh_state()
    bn, stats = ptrain.sharded_step(p, bn, opt, local, settings, "batch",
                                    device="cpu")
    save("batch", p, bn, stats)
    # the same step with a per-rank BatchNorm (the encoder's sum over the
    # ranks taken out): it must miss the JAX step
    all_sum = ptrain.all_sum
    ptrain.all_sum = lambda t: t
    try:
        p, bn, opt = fresh_state()
        bn, stats = ptrain.sharded_step(p, bn, opt, local, settings, "batch",
                                        device="cpu")
        save("batch_per_rank_bn", p, bn, stats)
    finally:
        ptrain.all_sum = all_sum

    stacked = stack_batches([data["plain"], data["plain2"]])
    p, bn, opt = fresh_state()
    bn, stats = ptrain.make_sharded_scan_step("rays")(
        p, bn, opt, stacked, settings, device="cpu")
    save("scan", p, bn, stats)
    if rank == 0:
        p, bn, opt = fresh_state()
        bn, stats = tstep.train_step_scan(p, bn, opt, stacked, settings,
                                          device="cpu")
        save("scan_single", p, bn, stats)

    nst = nerf.NerfStatic(depth=2, width=32, skips=())
    ns = NerfRenderSettings(model=nst, model_fine=nst, n_samples=8,
                            n_importance=8, perturb=False, chunk_rays=64)
    nbatch = {k: data["plain"][k] for k in
              ("ray_o", "ray_d", "near", "far", "rgb", "ray_mask")}
    for case, n in (("nerf", world), ("nerf_single", 1)):
        if n == 1 and rank != 0:
            continue
        p, _ = nerf.init(torch.Generator().manual_seed(0), nst, nst,
                         device="cpu")
        opt = Adam(p, lambda t: LR)
        _, stats = ptrain.make_sharded_train_step("rays", rank, n)(
            p, {}, opt, nbatch, ns, device="cpu")
        save(case, p, {}, stats)

    _trainer(data["zju"], out + ".ckpt", res)
    np.savez(out, **res)
    bootstrap.shutdown()


def _trainer(root, ckpt_dir, res):
    """The Trainer over a fake ZJU tree (a loader pool of one worker a
    rank): one epoch of two dispatches and a validate; rank 0 alone writes
    the checkpoint."""
    import neuralbody_tpu_torch.datasets  # noqa: F401
    from neuralbody_tpu_torch.config import make_cfg
    from neuralbody_tpu_torch.train.optimizer import tree_leaves
    from neuralbody_tpu_torch.train.trainer import Trainer
    cfg = make_cfg()    # tests/test_torch_datasets.py's small_cfg
    cfg.H = cfg.W = 64
    cfg.ratio = 1.0
    cfg.N_rand = 64
    cfg.num_train_frame = 2
    cfg.training_view = [0, 1]
    cfg.voxel_size = [0.02, 0.02, 0.02]
    cfg.nv = 400
    cfg.tpu.chunk_rays = 256
    cfg.train_dataset.data_root = root
    cfg.train_dataset.human = "CoreView_999"
    cfg.train_dataset.ann_file = f"{root}/annots.npy"
    cfg.test_dataset.update(cfg.train_dataset)
    cfg.test_dataset.split = "test"
    # one loader worker a rank: every rank's pool must give the same
    # batches (rays mode), which the ranks' bit-equal parameters show
    cfg.ep_iter, cfg.train.epoch, cfg.train.num_workers = 4, 1, 1
    cfg.tpu.steps_per_dispatch = 2
    cfg.trained_model_dir = ckpt_dir
    cfg.record_dir = ckpt_dir + "_rec"
    cfg.test.frame_sampler_interval = 4
    trainer = Trainer(cfg, device="cpu")
    try:
        assert trainer.run.bank is None and trainer.run.data_mode == "rays"
        trainer.fit()
        metrics = trainer.validate()
    finally:
        trainer.close()
    for i, x in enumerate(tree_leaves(trainer.params)):
        res[f"trainer/p{i}"] = x.detach().numpy()
    res["trainer/primary_metrics"] = np.asarray(
        metrics["psnr"] if trainer.is_primary else np.nan)
    res["trainer/ckpt"] = np.asarray(os.path.isdir(ckpt_dir)
                                     and bool(os.listdir(ckpt_dir)))


# -- the parent ---------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _frames(seed=5):
    """tests/test_batch_mode.py's frames at B = 2 over the plain scene's
    geometry (its static sizes hold), distinct rays and latent index a
    frame."""
    from neuralbody_tpu.utils.synthetic import make_batch
    base, _ = make_batch(n_rays=WORLD * R_PER, n_verts=512, voxel_size=VOX,
                         seed=seed)
    batch = {}
    for k, v in base.items():
        if k == "geom":
            batch[k] = {n: np.repeat(a, WORLD, axis=0) for n, a in v.items()}
        elif k in ("ray_o", "ray_d", "near", "far", "rgb", "ray_mask"):
            a = np.asarray(v)[0]
            batch[k] = a.reshape(WORLD, R_PER, *a.shape[1:])
        else:
            batch[k] = np.repeat(np.asarray(v), WORLD, axis=0)
    batch["latent_index"] = (np.arange(WORLD) % 4).astype(np.int32)
    # frame 1 places the vertices at each other's sites: the same site set
    # and static sizes, another encoder input, so that a BatchNorm over one
    # frame differs from one over both
    vi = batch["geom"]["vert_idx"]
    vi[1] = np.random.RandomState(seed).permutation(vi[1])
    return batch


def _inputs(tmp):
    import jax

    from neuralbody_tpu.models import latent_xyzc
    from neuralbody_tpu.utils.synthetic import make_batch
    plain, static = make_batch(n_rays=N_RAYS, n_verts=512, voxel_size=VOX,
                               seed=5)
    # a second step's batch: the same scene, its rays in another order
    plain2 = {k: (np.roll(v, 37, axis=1) if k in (
        "ray_o", "ray_d", "near", "far", "rgb", "ray_mask") else v)
        for k, v in plain.items()}
    _, derive = make_batch(n_rays=N_RAYS, n_verts=512, voxel_size=VOX,
                           seed=5, hat=True, n_samples=N_SAMPLES,
                           hat_perturb=False)
    hs = dict(derive["hat"])
    hs["n_groups"] = -(-hs["n_groups"] // 8) * 8   # shardable group axis
    hat, hstatic = make_batch(n_rays=N_RAYS, n_verts=512, voxel_size=VOX,
                              seed=5, hat=True, n_samples=N_SAMPLES,
                              hat_perturb=False, hat_static=hs)
    params, stats = latent_xyzc.init(jax.random.PRNGKey(0),
                                     num_train_frame=4, nv=512)
    from fake_data import make_fake_zju
    zju = make_fake_zju(str(tmp / "zju" / "CoreView_999"))
    return dict(
        plain=plain, plain2=plain2, hat=hat, frames=_frames(),
        rows_caps=tuple(hstatic["hat"]["rows_caps"]),
        static={"out_sh": static["out_sh"],
                "site_caps": static["site_caps"]},
        spec=dict(out_sh=tuple(static["out_sh"]),
                  site_caps=tuple(static["site_caps"]), group_size=128,
                  tile=(4, 8), n_groups=hs["n_groups"],
                  rows_caps=tuple(hs["rows_caps"]), seg_caps=(8, 8, 8, 8)),
        weights=(jax.tree.map(np.asarray, params),
                 jax.tree.map(np.asarray, stats)),
        zju=zju)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's]) of one two-rank spawn."""
    tmp = tmp_path_factory.mktemp("parallel")
    data = _inputs(tmp)
    inp = str(tmp / "inputs.pkl")
    with open(inp, "wb") as f:
        pickle.dump(data, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NB_", "RANK", "WORLD_SIZE", "MASTER_"))}
    env.update(PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               NB_COORDINATOR=f"localhost:{_free_port()}",
               NB_NUM_PROCESSES=str(WORLD), NB_DIST_TIMEOUT="120",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    outs = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), inp, outs[r]],
        env=dict(env, NB_PROCESS_ID=str(r)), cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=DEADLINE_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return data, [dict(np.load(o)) for o in outs]


def _leaves(res, case, kind="p"):
    head = f"{case}/{kind}"
    n = sum(1 for k in res if k.startswith(head) and k[len(head):].isdigit())
    return [res[f"{case}/{kind}{i}"] for i in range(n)]


def _assert_tree_close(got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"{what} {i}",
                                   **tol)


def _jax_settings(data):
    from neuralbody_tpu.models.latent_xyzc import ModelStatic
    from neuralbody_tpu.models.sparse_conv_net import EncoderStatic
    from neuralbody_tpu.renderer.renderer import RenderSettings
    st = data["static"]
    return RenderSettings(
        model=ModelStatic(encoder=EncoderStatic(out_sh=st["out_sh"],
                                                site_caps=st["site_caps"])),
        voxel_size=(VOX,) * 3, n_samples=N_SAMPLES, chunk_rays=N_RAYS,
        perturb=False)


def _jax_steps(data, batch, settings, mode="rays"):
    """(one device, two-device mesh) results of the JAX step: params,
    bn_stats, Adam's first moments and stats."""
    import jax
    import jax.numpy as jnp
    import optax

    from neuralbody_tpu.parallel.mesh import make_mesh, shard_batch
    from neuralbody_tpu.parallel.train import make_sharded_train_step
    from neuralbody_tpu.train.step import train_step
    tx = optax.chain(optax.clip(40.0), optax.adam(LR))
    key = jax.random.PRNGKey(9)
    params, bn = jax.tree.map(jnp.asarray, data["weights"])
    out = [train_step(params, bn, tx.init(params),
                      jax.tree.map(jnp.asarray, batch), key, settings, tx)]
    mesh = make_mesh(WORLD)
    step = make_sharded_train_step(mesh, settings, tx, batch, mode=mode)
    params, bn = jax.tree.map(jnp.asarray, data["weights"])
    out.append(step(params, bn, tx.init(params),
                    shard_batch(mesh, batch, mode=mode), key))
    return [(jax.tree.leaves(p), jax.tree.leaves(s),
             jax.tree.leaves(o[1][0].mu), st) for p, s, o, st in out]


def _params_close(got, want, want_mu, what):
    """The parameters after one Adam step against JAX's, leaf by leaf
    (want_mu: JAX's first moments, 0.1 x the gradient). Adam's first step
    is lr * sign(g) wherever |g| is well above its eps, so where the two
    packages' gradients differ in sign an element moves 2 lr apart. Every
    element within PARAM_TOL, but for at most MISS_SHARE of a leaf's
    elements (at least one), each of them one whose JAX gradient is under
    NEAR_ZERO of its leaf's largest."""
    assert len(got) == len(want) == len(want_mu), what
    for i, (g, w, mu) in enumerate(zip(got, want, want_mu)):
        w, mu = np.asarray(w), np.abs(np.asarray(mu))
        bad = ~np.isclose(g, w, **PARAM_TOL)
        assert bad.sum() <= max(1, MISS_SHARE * bad.size), \
            (what, i, int(bad.sum()), bad.size)
        assert np.all(mu[bad] <= NEAR_ZERO * mu.max()), \
            (what, i, mu[bad].max() / mu.max())


def _matches_jax(runs, case, batch_key, settings=None, mode="rays",
                 bn=False):
    data, (res, _) = runs
    settings = settings or _jax_settings(data)
    out = _jax_steps(data, data[batch_key], settings, mode)
    for p, s, mu, st in out:
        np.testing.assert_allclose(res[f"{case}/loss"], float(st["loss"]),
                                   **LOSS_TOL)
        _params_close(_leaves(res, case), p, mu, case)
        if bn:
            _assert_tree_close(_leaves(res, case, "bn"), s, PARAM_TOL,
                               f"{case} bn")
    return out


def test_plain_step_matches_jax(runs):
    """Rays mode, the plan-free render: each rank renders half the rays,
    the loss divides by every rank's valid rays."""
    _matches_jax(runs, "plain", "plain")


def test_hat_step_with_group_sharding_matches_jax(runs):
    """Rays mode on the hat path: each rank decodes half the groups, the
    raw field is gathered, every rank composites all rays."""
    data, _ = runs
    s = _jax_settings(data)._replace(hat_rows_caps=data["rows_caps"])
    _matches_jax(runs, "hat", "hat", settings=s)


def test_batch_mode_syncs_batch_norm_over_the_ranks(runs):
    """Batch mode, one frame a rank: the JAX step's joint BatchNorm (its
    running stats included); a per-rank BatchNorm misses it."""
    (_, s, _, _), _ = _matches_jax(runs, "batch", "frames", mode="batch",
                                   bn=True)
    _, (res, _) = runs
    worst = max(np.abs(g - np.asarray(w)).max() / (
        PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(np.asarray(w)).max())
        for g, w in zip(_leaves(res, "batch_per_rank_bn", "bn"), s))
    assert worst > 10, worst


@pytest.mark.parametrize("case,batch_key", [("eval", "plain"),
                                            ("eval_hat", "hat")])
def test_sharded_eval_matches_jax_eval_step(runs, case, batch_key):
    import jax
    import jax.numpy as jnp

    from neuralbody_tpu.train.step import eval_step
    data, (res, res1) = runs
    s = _jax_settings(data)
    if batch_key == "hat":
        s = s._replace(hat_rows_caps=data["rows_caps"])
    want = eval_step(jax.tree.map(jnp.asarray, data["weights"][0]),
                     jax.tree.map(jnp.asarray, data[batch_key]), s)
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(res[f"{case}/{k}"], np.asarray(want[k]),
                                   err_msg=k, **EVAL_TOL)
        np.testing.assert_array_equal(res[f"{case}/{k}"],
                                      res1[f"{case}/{k}"])


@pytest.mark.parametrize("case", ["plain", "hat", "device_plan", "scan",
                                  "nerf"])
def test_matches_the_one_process_step(runs, case):
    """The two-rank step against the port's one-process step on the whole
    batch (train_step; for scan train_step_scan over two batches)."""
    _, (res, _) = runs
    np.testing.assert_allclose(res[f"{case}/loss"],
                               res[f"{case}_single/loss"], **LOSS_TOL)
    _assert_tree_close(_leaves(res, case), _leaves(res, f"{case}_single"),
                       PARAM_TOL, case)
    _assert_tree_close(_leaves(res, case, "bn"),
                       _leaves(res, f"{case}_single", "bn"), PARAM_TOL,
                       f"{case} bn")
    if case == "device_plan":
        assert res["device_plan/plan_overflow"] == 0.0


def test_ranks_end_bit_equal(runs):
    """Every parameter and BatchNorm stat, and every stat, of every case is
    the same on both ranks (but the per-rank BatchNorm's: each rank keeps
    its own frame's stats there)."""
    _, (res0, res1) = runs
    shared = [k for k in res1 if not k.startswith(
        ("trainer/primary", "trainer/ckpt", "batch_per_rank_bn/"))]
    assert len(shared) > 100
    for k in shared:
        np.testing.assert_array_equal(res0[k], res1[k], err_msg=k)


def test_trainer_writes_on_the_primary_rank_only(runs):
    _, (res0, res1) = runs
    assert bool(res0["trainer/ckpt"]) and not bool(res1["trainer/ckpt"])
    assert np.isfinite(res0["trainer/primary_metrics"])
    assert np.isnan(res1["trainer/primary_metrics"])


def test_layout_matches_jax_batch_shardings():
    """batch_layout's split axes against JAX batch_shardings' specs, for a
    plan-free and a hat batch (stacked and not) in both modes; the one
    deliberate difference: hat_wpts / hat_vdir split on the group axis
    (ADVICE.md on neuralbody_tpu/parallel/mesh.py:93)."""
    from jax.sharding import PartitionSpec as P

    from neuralbody_tpu.parallel.mesh import batch_shardings, make_mesh
    from neuralbody_tpu.utils.synthetic import make_batch
    from neuralbody_tpu_torch.parallel.mesh import batch_layout
    jmesh = make_mesh(WORLD)
    plain, _ = make_batch(n_rays=N_RAYS, n_verts=512, voxel_size=VOX,
                          seed=5)
    hat, st = make_batch(n_rays=N_RAYS, n_verts=512, voxel_size=VOX, seed=5,
                         hat=True, n_samples=N_SAMPLES)
    ngrp = hat["hat_seg_a1"].shape[1]
    assert ngrp % WORLD == 0
    hat["hat_wpts"] = np.zeros((1, ngrp, 128, 3), np.float32)
    hat["hat_vdir"] = np.zeros((1, ngrp, 128, 3), np.float32)
    odd = dict(hat, hat_seg_a1=hat["hat_seg_a1"][:, :ngrp - 1])
    for batch in (plain, hat, odd):
        for stacked in (False, True):
            b = ({k: (v if isinstance(v, dict) else v[None])
                  for k, v in batch.items()} if stacked else batch)
            for mode in ("rays", "batch"):
                want = batch_shardings(jmesh, b, stacked, mode)
                got = batch_layout(b, WORLD, stacked, mode)
                assert sorted(got) == sorted(want)
                for k, (what, axis) in got.items():
                    w = want[k]
                    spec = (next(iter(w.values())) if isinstance(w, dict)
                            else w).spec
                    if (k in ("hat_wpts", "hat_vdir") and mode == "rays"
                            and batch is hat):
                        assert what == "groups" and spec == P(), k
                        continue
                    split = [i for i, a in enumerate(spec) if a == "data"]
                    assert split == ([] if axis is None else [axis]), (
                        k, mode, stacked, spec, what)


def test_one_rank_steps_are_the_plain_ones():
    """With one rank the sharded steps are the plain steps themselves (the
    card's graphs included); the banked scan step is single-process, as
    in the JAX package."""
    from neuralbody_tpu_torch.parallel import train as ptrain
    from neuralbody_tpu_torch.train import step as tstep
    assert ptrain.make_sharded_train_step("rays", 0, 1) is tstep.train_step
    assert (ptrain.make_sharded_scan_step("batch", 0, 1)
            is tstep.train_step_scan)
    assert (ptrain.make_sharded_scan_step_banked(world=1)
            is tstep.train_step_scan_banked)
    with pytest.raises(ValueError, match="single-process"):
        ptrain.make_sharded_scan_step_banked(world=2)
    with pytest.raises(ValueError, match="mode"):
        ptrain.sharded_step({}, {}, None, {}, None, mode="frames", rank=0,
                            world=2, device="cpu")


def test_bootstrap_reads_the_environment(monkeypatch):
    """No variables: a single process, nothing formed. NB_COORDINATOR /
    NB_NUM_PROCESSES / NB_PROCESS_ID: tcp:// with that rank and world;
    NB_DIST_AUTO: env://; gloo on the CPU; the group's timeout from
    NB_DIST_TIMEOUT."""
    import torch.distributed as dist

    from neuralbody_tpu_torch.parallel import bootstrap
    for k in ("NB_COORDINATOR", "NB_DIST_AUTO", "NB_DIST_BACKEND",
              "NB_DIST_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)
    assert not bootstrap.maybe_initialize_distributed(device="cpu")
    assert (bootstrap.rank(), bootstrap.world(), bootstrap.is_primary()) \
        == (0, 1, True)
    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: seen.append(kw))
    monkeypatch.setenv("NB_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("NB_NUM_PROCESSES", "4")
    monkeypatch.setenv("NB_PROCESS_ID", "3")
    monkeypatch.setenv("NB_DIST_TIMEOUT", "7")
    assert bootstrap.maybe_initialize_distributed(device="cpu")
    monkeypatch.delenv("NB_COORDINATOR")
    monkeypatch.setenv("NB_DIST_AUTO", "1")
    assert bootstrap.maybe_initialize_distributed(device="cpu")
    a, b = seen
    assert a["init_method"] == "tcp://localhost:1234"
    assert (a["rank"], a["world_size"], a["backend"]) == (3, 4, "gloo")
    assert a["timeout"].total_seconds() == 7
    assert b["init_method"] == "env://" and "rank" not in b


def test_a_group_that_does_not_form_raises(monkeypatch):
    """Rank 0 of two with no rank 1: the group's timeout raises."""
    from neuralbody_tpu_torch.parallel import bootstrap
    monkeypatch.delenv("NB_DIST_AUTO", raising=False)
    monkeypatch.setenv("NB_COORDINATOR", f"localhost:{_free_port()}")
    monkeypatch.setenv("NB_NUM_PROCESSES", "2")
    monkeypatch.setenv("NB_PROCESS_ID", "0")
    monkeypatch.setenv("NB_DIST_TIMEOUT", "3")
    with pytest.raises(Exception, match="(?i)time|connect|store"):
        bootstrap.maybe_initialize_distributed(device="cpu")
    assert bootstrap.world() == 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    _worker(sys.argv[1], sys.argv[2])
