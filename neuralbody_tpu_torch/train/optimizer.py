"""Learning-rate schedules and the optimizers (counterpart of
neuralbody_tpu/train/optimizer.py).

The reference recipe: gradient value-clip 40 (optax.clip, the reference's
clip_grad_value_), optional coupled weight decay, then Adam (b1 0.9,
b2 0.999, eps 1e-8), RAdam (optax.radam, eps 1e-8, threshold 5) or SGD
with momentum 0.9 (no weight decay, as the JAX package's chain skips it
for sgd). The epoch is the step count over ep_iter. As in optax, the
learning rate of step t (0-based) is schedule(t): the schedule is read at
the count before it increments. make_optimizer(cfg, params) builds the
config's optimizer and schedule, as the JAX package's make_optimizer(cfg)
does.

The optimizers work on the port's parameter dict (nested dicts and lists
of tensors) and update it in place; state_dict() is their state as trees
of the params' structure (Adam and RAdam: mu, nu, count; SGD: trace,
count), which train/checkpoint.py writes in optax's layout and
utils/transplant.opt_state_from_jax carries over from an optax run. Only
Adam runs inside a CUDA graph (train/graphs.StepGraph reads its moments
and per-step scalars); RAdam and SGD train through eager steps.
"""
from __future__ import annotations

import numpy as np
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


def _load_tree(dst, src, what):
    """Copy the tensors of tree `src` into those of `dst` (same structure
    and shapes), which keep their device and their addresses."""
    dst, src = tree_leaves(dst), tree_leaves(src)
    if len(dst) != len(src) or any(d.shape != s.shape
                                   for d, s in zip(dst, src)):
        raise ValueError(f"{what} differs in structure from the "
                         "optimizer's state")
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(s)


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


class _Moments:
    """What Adam and RAdam share: the value clip, the coupled weight decay
    and the two moments, with optax's arithmetic:

        g  = clip(grad, -clip, clip) (+ weight_decay * param)
        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
    """

    def __init__(self, params, schedule, clip=40.0, weight_decay=0.0,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.schedule = schedule
        self.clip = float(clip)
        self.weight_decay = float(weight_decay)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.mu = _zeros(params)
        self.nu = _zeros(params)
        self.count = 0

    def state_dict(self):
        """{mu, nu, count}: the moments themselves (not copies)."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state):
        """Take mu, nu (trees of the params' structure) and count, e.g. from
        utils/transplant.opt_state_from_jax or a checkpoint. The values are
        copied into this optimizer's own tensors, which keep their device
        and their addresses (a captured step reads and writes them
        there)."""
        for name in ("mu", "nu"):
            _load_tree(getattr(self, name), state[name], name)
        self.count = int(state["count"])

    def _moments(self, params, grads):
        """Update mu and nu from `grads` in place; returns (params' leaves,
        mu's, nu's)."""
        p, g = tree_leaves(params), tree_leaves(grads)
        m, v = tree_leaves(self.mu), tree_leaves(self.nu)
        if not len(p) == len(g) == len(m) == len(v):
            raise ValueError("params, grads and state differ in structure")
        g = [x.clamp(-self.clip, self.clip) for x in g]
        if self.weight_decay > 0:
            torch._foreach_add_(g, p, alpha=self.weight_decay)
        # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu (optax's order)
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(v, self.b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - self.b2))
        return p, m, v


class Adam(_Moments):
    """Value clip -> coupled weight decay -> Adam, with optax's arithmetic:

        g  = clip(grad, -clip, clip) (+ weight_decay * param)
        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
        param -= schedule(count - 1) * (mu / (1 - b1^count))
                 / (sqrt(nu / (1 - b2^count)) + eps)

    The three numbers that change from step to step (the learning rate and
    the two bias corrections) are read from a tensor beside the parameters,
    one row of scalars() a step: an eager step takes its row from a table
    of the next TABLE_STEPS steps (one host-to-device copy per table), a
    step captured in a CUDA graph (train/graphs.py) from the graph's own
    buffer. Both run the same operations, so a graphed step gives an eager
    step's bits; on the CPU they are the bits of Python-float scalars.
    step_graph is the captured dispatch that train/step.train_step_scan
    replays for this optimizer on the card (None until its first call).
    """

    TABLE_STEPS = 64

    def __init__(self, params, schedule, clip=40.0, weight_decay=0.0,
                 b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, schedule, clip, weight_decay, b1, b2, eps)
        self.step_graph = None
        self._table = None   # (first step, [TABLE_STEPS, 3] scalars)

    def scalars(self, n=1):
        """The learning rate and the two bias corrections of the next n
        steps, [n, 3] f32 on the CPU: row i is (schedule(t), 1 - b1^(t+1),
        1 - b2^(t+1)) for t = count + i, computed in double precision as an
        eager step computes them and rounded to f32 once, as the foreach
        kernels round a Python scalar."""
        rows = [(self.schedule(t), 1.0 - self.b1 ** (t + 1),
                 1.0 - self.b2 ** (t + 1))
                for t in range(self.count, self.count + n)]
        return torch.tensor(rows, dtype=torch.float32)

    def _row(self, device):
        """This step's row of scalars() on `device`, from the table of the
        next TABLE_STEPS steps, made again when count leaves it."""
        if (self._table is None or self._table[1].device != device
                or not 0 <= self.count - self._table[0] < self.TABLE_STEPS):
            self._table = (self.count,
                           self.scalars(self.TABLE_STEPS).to(device))
        return self._table[1][self.count - self._table[0]]

    @torch.no_grad()
    def step(self, params, grads, scalars=None):
        """Update the tensors of `params` in place from `grads` (a tree of
        the same structure, every leaf a tensor) and advance count by one.

        scalars: this step's row of scalars(), a [3] f32 tensor on the
        params' device (a step captured in a CUDA graph passes its buffer's
        row and owns its agreement with count); None takes the row of
        count from the optimizer's own table."""
        p, m, v = self._moments(params, grads)
        if scalars is None:
            scalars = self._row(p[0].device)
        lr, bc1, bc2 = scalars.unbind()
        self.count += 1
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)


def _f32_pow(base, n):
    """base ** n for an integer n as optax computes it in f32 (XLA's power
    of the f32 base: the f32 base raised in f64 and rounded once, which
    XLA's result is within an ulp of)."""
    return np.float32(np.float64(np.float32(base)) ** n)


class RAdam(_Moments):
    """Value clip -> coupled weight decay -> RAdam (optax.scale_by_radam
    with eps 1e-8 and its threshold 5, then the learning rate):

        (mu, nu as Adam's);  t = count + 1
        ro = ro_inf - 2 t b2^t / (1 - b2^t),  ro_inf = 2 / (1 - b2) - 1
        u  = mu / (1 - b1^t)                                  if ro < 5
        u  = r mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) otherwise,
             r = sqrt((ro - 4)(ro - 2) ro_inf / ((ro_inf - 4)(ro_inf - 2) ro))
        param -= schedule(t - 1) u

    ro cancels ~2000 against ~2000 in its first steps, so the step's
    scalars are computed on the host in f32 in optax's order (f32 powers
    as _f32_pow): a float64 ro would move r by up to 1% from optax's.
    Eager only (train/step.train_step_scan sends it to the plain loop).
    """

    THRESHOLD = 5.0

    def scalars(self):
        """This step's (learning rate, 1 - b1^t, 1 - b2^t, r or None when ro
        is under the threshold) as Python floats, t = count + 1."""
        t = self.count + 1
        f32 = np.float32
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = _f32_pow(self.b2, t)
        ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1.0) - b2t)
        r = None
        if ro >= self.THRESHOLD:
            r = float(np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                              / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        return (float(self.schedule(self.count)),
                float(f32(1.0) - _f32_pow(self.b1, t)),
                float(f32(1.0) - _f32_pow(self.b2, t)), r)

    @torch.no_grad()
    def step(self, params, grads):
        """Update the tensors of `params` in place from `grads` and advance
        count by one."""
        lr, bc1, bc2, r = self.scalars()
        p, m, v = self._moments(params, grads)
        self.count += 1
        upd = torch._foreach_div(m, bc1)
        if r is not None:
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_mul(upd, r)
            torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)


class SGD:
    """Value clip -> SGD with momentum (optax.sgd(schedule, momentum=0.9),
    no weight decay):

        trace = clip(grad, -clip, clip) + momentum * trace;   count += 1
        param -= schedule(count - 1) * trace

    Eager only (train/step.train_step_scan sends it to the plain loop)."""

    weight_decay = 0.0   # the JAX chain has no decay for sgd
    momentum = 0.9       # optax.sgd's momentum in the JAX chain

    def __init__(self, params, schedule, clip=40.0):
        self.schedule = schedule
        self.clip = float(clip)
        self.trace = _zeros(params)
        self.count = 0

    def state_dict(self):
        """{trace, count}: the trace itself (not a copy)."""
        return {"trace": self.trace, "count": self.count}

    def load_state_dict(self, state):
        """Take trace and count, copied into this optimizer's own
        tensors."""
        _load_tree(self.trace, state["trace"], "trace")
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, params, grads):
        p, g = tree_leaves(params), tree_leaves(grads)
        t = tree_leaves(self.trace)
        if not len(p) == len(g) == len(t):
            raise ValueError("params, grads and state differ in structure")
        lr = float(self.schedule(self.count))
        self.count += 1
        g = [x.clamp(-self.clip, self.clip) for x in g]
        torch._foreach_mul_(t, self.momentum)
        torch._foreach_add_(t, g)
        torch._foreach_add_(p, torch._foreach_mul(t, -lr))


def build_optimizer(params, schedule, optim="adam", clip=40.0,
                    weight_decay=0.0):
    """The reference's optimizer `optim` over `params` behind a value clip:
    Adam or RAdam with eps 1e-8 and optional coupled weight decay, or SGD
    with momentum 0.9 (weight decay ignored, as the JAX chain ignores
    it)."""
    if optim == "adam":
        return Adam(params, schedule, clip=clip, weight_decay=weight_decay)
    if optim == "radam":
        return RAdam(params, schedule, clip=clip, weight_decay=weight_decay)
    if optim == "sgd":
        return SGD(params, schedule, clip=clip)
    raise ValueError(f"unknown optimizer {optim!r}")


def lr_schedule_from_cfg(cfg):
    """cfg.train's learning rate and scheduler as a schedule (the JAX
    package's make_lr_schedule(cfg))."""
    sch = cfg.train.scheduler
    return make_lr_schedule(
        cfg.train.lr, sch.type, ep_iter=cfg.ep_iter, gamma=sch.gamma,
        decay_epochs=sch.get("decay_epochs", 1000),
        milestones=tuple(sch.get("milestones", ())),
        warmup_factor=sch.get("warmup_factor", 1.0 / 3),
        warmup_iters=sch.get("warmup_iters", 5),
        warmup_method=sch.get("warmup_method", "linear"))


def make_optimizer(cfg, params):
    """(optimizer over `params`, schedule) from cfg.train's optim, learning
    rate, scheduler and weight decay and cfg.grad_clip_value (the JAX
    package's make_optimizer(cfg))."""
    schedule = lr_schedule_from_cfg(cfg)
    opt = build_optimizer(params, schedule, optim=cfg.train.optim,
                          clip=float(cfg.get("grad_clip_value", 40.0)),
                          weight_decay=float(cfg.train.weight_decay))
    return opt, schedule
