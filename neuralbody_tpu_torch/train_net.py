"""Training entry point of the port (mirrors the root train_net.py):

    python -m neuralbody_tpu_torch.train_net --cfg_file CFG [--device cpu]
        [--test] [opts ...]

builds the config (make_cfg_from_args: the YAML, then `key value` opts),
seeds numpy with cfg.seed when cfg.fix_random, trains with
train/trainer.Trainer(cfg).fit() (resuming from cfg.trained_model_dir's
latest checkpoint when cfg.resume) and validates unless cfg.skip_eval.
--test sets train.epoch to 0: validation of the latest checkpoint only.
It runs on the card unless --device cpu is given.

It forms the process group first, as the root train_net.py does
(parallel/bootstrap.py: NB_COORDINATOR / NB_NUM_PROCESSES / NB_PROCESS_ID,
or NB_DIST_AUTO=1 under torchrun; NCCL on the card, gloo with --device
cpu), and destroys it at the end. Two ranks on the CPU:

    NB_COORDINATOR=localhost:29500 NB_NUM_PROCESSES=2 NB_PROCESS_ID=0 \
        python -m neuralbody_tpu_torch.train_net --device cpu --cfg_file CFG &
    NB_COORDINATOR=localhost:29500 NB_NUM_PROCESSES=2 NB_PROCESS_ID=1 \
        python -m neuralbody_tpu_torch.train_net --device cpu --cfg_file CFG

and on the cards of one host: NB_DIST_AUTO=1 torchrun --nproc_per_node N
-m neuralbody_tpu_torch.train_net --cfg_file CFG.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None)
    ns, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)

    # the process group first, before any card is touched
    from .parallel import bootstrap
    if bootstrap.maybe_initialize_distributed(device=ns.device):
        import torch.distributed as dist
        print(f"process group: rank {bootstrap.rank()} of "
              f"{bootstrap.world()}, backend {dist.get_backend()}",
              flush=True)

    from .config import make_cfg_from_args
    cfg, args = make_cfg_from_args(rest)
    if args.test:
        cfg.train.epoch = 0
    if cfg.fix_random:
        # cfg.seed governs every random domain: the loader reseeds numpy per
        # batch from it, the weights and the render's draws use it
        import numpy as np
        np.random.seed(cfg.seed)

    from .train.trainer import Trainer
    try:
        trainer = Trainer(cfg, device=ns.device)
        try:
            trainer.fit()
            if not cfg.skip_eval:
                trainer.validate()
        finally:
            trainer.close()
    finally:
        bootstrap.shutdown()


if __name__ == "__main__":
    main()
