"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
tiny size, one fault planted in the port for each kind a cell can have
(one card: no exchange between chips to leave out), and for training two
more: the steps of a dispatch on one batch, and targets paired with the
wrong pixels."""
import pytest
import torch

from benchmark.tests.tiny import run_tiny


def _unchanged_state(monkeypatch):
    from neuralbody_tpu_torch.train import optimizer

    def step(self, params, grads, scalars=None):
        self.count += 1      # the moments and parameters left as they were
    monkeypatch.setattr(optimizer.Adam, "step", step)


def _half_batch_train(monkeypatch):
    from neuralbody_tpu_torch.train import step
    plain = step.masked_mse

    def masked_mse(pred, target, mask, count=None):
        R = mask.shape[-1]
        return plain(pred[..., :R // 2, :], target[..., :R // 2, :],
                     mask[..., :R // 2])
    monkeypatch.setattr(step, "masked_mse", masked_mse)


def _one_batch_a_dispatch(monkeypatch):
    """Every step of a dispatch trains on its first batch: a stale staging
    slot, or the bank's rows indexed by the dispatch, not the step."""
    from neuralbody_tpu_torch.train import fresh
    plain = fresh.ConfigRun.stage

    def stage(self, item):
        group, keys = item
        return plain(self, ([group[0]] * len(group), [keys[0]] * len(keys)))
    monkeypatch.setattr(fresh.ConfigRun, "stage", stage)


def _target_shifted(monkeypatch):
    """The loader pairs each ray with the pixel of the ray before it."""
    import numpy as np
    from neuralbody_tpu_torch.datasets import ray_utils
    plain = ray_utils.sample_rays_train

    def sample_rays_train(*args, **kw):
        rgb, *rest = plain(*args, **kw)
        return (np.roll(rgb, 1, axis=0), *rest)
    monkeypatch.setattr(ray_utils, "sample_rays_train", sample_rays_train)


def _eval_fault(monkeypatch, alter):
    from neuralbody_tpu_torch.train import step
    plain = step.eval_step

    def eval_step(params, batch, settings, device=None):
        ret = plain(params, batch, settings, device=device)
        alter(ret["rgb_map"], int(torch.as_tensor(batch["ray_mask"]).sum()))
        return ret
    monkeypatch.setattr(step, "eval_step", eval_step)


def _answer_altered(monkeypatch):
    def alter(rgb, n):
        rgb[0, 0] += 0.05
    _eval_fault(monkeypatch, alter)


def _half_batch_render(monkeypatch):
    def alter(rgb, n):
        rgb[0, n // 2:n] = 0.0     # half of the image's rays never rendered
    _eval_fault(monkeypatch, alter)


FAULTS = [("latent_xyzc_313.train", _unchanged_state),
          ("latent_xyzc_313.train", _half_batch_train),
          ("latent_xyzc_313.train", _one_batch_a_dispatch),
          ("latent_xyzc_313.train", _target_shifted),
          ("nerf_313.train", _unchanged_state),
          ("nerf_313.train", _half_batch_train),
          ("nerf_313.train", _one_batch_a_dispatch),
          ("nerf_313.train", _target_shifted),
          ("latent_xyzc_313.render", _answer_altered),
          ("latent_xyzc_313.render", _half_batch_render),
          ("nerf_313.render", _answer_altered),
          ("nerf_313.render", _half_batch_render)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    torch.set_num_threads(2)
    fault(monkeypatch)
    out = run_tiny(monkeypatch, cell, seed=5)
    assert not out["correct"], out["checks"]
