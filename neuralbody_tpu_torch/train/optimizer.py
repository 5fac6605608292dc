"""Learning-rate schedules and the optimizer (counterpart of
neuralbody_tpu/train/optimizer.py).

The reference recipe: gradient value-clip 40 (optax.clip, the reference's
clip_grad_value_), optional coupled weight decay, then Adam (b1 0.9,
b2 0.999, eps 1e-8). The epoch is the step count over ep_iter. As in
optax, the learning rate of step t (0-based) is schedule(t): the schedule
is read at the count before it increments.

The optimizer works on the port's parameter dict (nested dicts and lists of
tensors) and updates it in place; its state (mu, nu: trees of the params'
structure; count) is what utils/transplant.opt_state_from_jax carries over
from an optax run.
"""
from __future__ import annotations

import torch


def make_lr_schedule(lr, scheduler="exponential", ep_iter=1, gamma=0.1,
                     decay_epochs=1000, milestones=(), warmup_factor=1.0 / 3,
                     warmup_iters=5, warmup_method="linear"):
    """step -> learning rate, for the reference's three scheduler types.

    exponential:        lr * gamma ** (epoch / decay_epochs)
    multi_step:         lr * gamma ** (number of milestones <= epoch)
    warmup_multi_step:  multi_step times a warmup factor over the first
                        warmup_iters epochs (linear ramp from warmup_factor
                        to 1, or constant warmup_factor)
    with epoch = step // ep_iter.
    """
    base_lr = float(lr)
    ep_iter = max(int(ep_iter), 1)
    gamma = float(gamma)
    milestones = list(milestones)

    def steps_down(epoch):
        return gamma ** sum(epoch >= m for m in milestones)

    if scheduler == "exponential":
        decay_epochs = float(decay_epochs)

        def schedule(step):
            return base_lr * gamma ** ((step // ep_iter) / decay_epochs)

    elif scheduler == "multi_step":
        def schedule(step):
            return base_lr * steps_down(step // ep_iter)

    elif scheduler == "warmup_multi_step":
        wf, wi = float(warmup_factor), float(warmup_iters)
        if warmup_method not in ("linear", "constant"):
            raise ValueError(f"unknown warmup method {warmup_method!r}")

        def schedule(step):
            epoch = step // ep_iter
            warm = 1.0
            if epoch < wi:
                if warmup_method == "linear":
                    alpha = min(epoch / wi, 1.0)
                    warm = wf * (1 - alpha) + alpha
                else:
                    warm = wf
            return base_lr * warm * steps_down(epoch)

    else:
        raise ValueError(f"unknown scheduler type {scheduler!r}")
    return schedule


def tree_leaves(tree):
    """Tensors of a nested dict/list tree, dict keys in sorted order (the
    order jax.tree flattens in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """fn applied to every tensor of a nested dict/list tree, in
    tree_leaves' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


class Adam:
    """Value clip -> coupled weight decay -> Adam, with optax's arithmetic:

        g  = clip(grad, -clip, clip) (+ weight_decay * param)
        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
        param -= schedule(count - 1) * (mu / (1 - b1^count))
                 / (sqrt(nu / (1 - b2^count)) + eps)
    """

    def __init__(self, params, schedule, clip=40.0, weight_decay=0.0,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.schedule = schedule
        self.clip = float(clip)
        self.weight_decay = float(weight_decay)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.mu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)
        self.nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)
        self.count = 0

    def load_state_dict(self, state):
        """Take mu, nu (trees of the params' structure) and count, e.g. from
        utils/transplant.opt_state_from_jax. The tensors move to where this
        optimizer's state lives."""
        dev = tree_leaves(self.mu)[0].device
        self.mu = tree_map(lambda t: t.to(dev, torch.float32), state["mu"])
        self.nu = tree_map(lambda t: t.to(dev, torch.float32), state["nu"])
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, params, grads):
        """Update the tensors of `params` in place from `grads` (a tree of
        the same structure, every leaf a tensor)."""
        p, g = tree_leaves(params), tree_leaves(grads)
        m, v = tree_leaves(self.mu), tree_leaves(self.nu)
        if not len(p) == len(g) == len(m) == len(v):
            raise ValueError("params, grads and state differ in structure")
        lr = self.schedule(self.count)
        self.count += 1
        g = [x.clamp(-self.clip, self.clip) for x in g]
        if self.weight_decay > 0:
            torch._foreach_add_(g, p, alpha=self.weight_decay)
        # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu (optax's order)
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(v, self.b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - self.b2))
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)


def make_optimizer(params, schedule, optim="adam", clip=40.0,
                   weight_decay=0.0):
    """The reference's optimizer over `params`: Adam with eps 1e-8 behind a
    value clip and optional coupled weight decay."""
    if optim == "adam":
        return Adam(params, schedule, clip=clip, weight_decay=weight_decay)
    if optim in ("radam", "sgd"):
        raise NotImplementedError(
            f"optimizer {optim!r} comes with the training-harness slice of "
            "the port; the latent_xyzc configs train with adam")
    raise ValueError(f"unknown optimizer {optim!r}")
