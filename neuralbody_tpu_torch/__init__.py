"""neuralbody_tpu_torch: the PyTorch/CUDA port of neuralbody_tpu for an
NVIDIA H100.

It mirrors the JAX package's layout and imports neither JAX nor the JAX
package. What it holds:

  * config/: CfgNode, make_cfg (parent_cfg, CLI opts, the vis_* overlays)
    and the plugin registry; the YAMLs under configs/ load unchanged.
  * datasets/: the ZJU-MoCap multi-view and People-Snapshot monocular
    datasets, their samplers and ray sampling, the loader
    (make_data_loader) with its spawned workers, the demo datasets (orbit,
    novel-pose playback, rotated SMPL) and the mesh datasets.
  * models/: latent_xyzc (SparseConvNet encoder + decode MLP) and the NeRF
    baseline, with their registered factories.
  * ops/: the sparse-conv rulebook and convs, the hat planner (numpy, and
    C++ in csrc/hat_planner.cpp) and hat interpolation, compositing,
    sampling; the hand-written CUDA kernels' wrappers (hat_kernel,
    conv_kernel, dense_kernel over csrc/*.cu).
  * renderer/: latent_xyzc's hat-path and plan-free renders, the NeRF
    baseline's coarse + fine render, their settings factories, and mesh
    extraction (mesh.py: the density grid, then the C++ iso-surface).
  * parallel/: the device geometry bank (geom.py) and the prefetcher that
    stages each dispatch group through pinned buffers on a side stream
    (transfer.py).
  * train/: train_step, eval_step and the NeRF steps, Adam, RAdam and SGD,
    the CUDA graphs of the G-step dispatch (train_step_scan,
    train_step_scan_banked) and of a hat render, fresh.py, training from a
    config through the datasets, the loader, the bank and the prefetcher,
    and the harness: trainer.Trainer (fit, resume, validate), checkpoints
    in the JAX package's file layout, the recorder.
  * evaluators/: PSNR / SSIM and the "if_nerf", "neural_volume" and
    "if_nerf_mesh" evaluators; visualizers/: the PNG and PLY sinks.
  * utils/: transplants from the JAX package and the reference's .pth,
    profiling, the synthetic scenes, a fake ZJU-MoCap writer, PLY IO, the
    iso-surface binding, VoxelGrid and the skeleton plots.
  * train_net.py: the training entry point
    (python -m neuralbody_tpu_torch.train_net --cfg_file ...); run.py: the
    tool entry point (dataset, network, evaluate, visualize, light_stage,
    evaluate_nv); tools/: the quality runs (convergence_run,
    novel_pose_eval), graph_noise, the kernel variants, render_mesh.
  * bench.py: the training throughput bench (fresh and broadcast halves).

Entry points run on the card unless the caller passes device="cpu", where
every kernel's plain PyTorch version runs instead.
"""
