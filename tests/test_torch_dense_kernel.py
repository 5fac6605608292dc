"""The dense layer of the port (ops/dense_kernel.py) on the CPU: its plain
version against the JAX product and against the TPU probe kernel it
replaces, the autograd Functions (`matmul`, and `linear` with the bias and
the ReLU in its epilogue) against jax.vjp of the JAX package's dense layer,
and the Python side of the kernel's wrapper (route and split plans,
refusals).

The probe (tools/probes/pallas_enc_interp.py:22-34) defines `mm` under a
`sys.argv` branch, so it cannot be imported; `_pallas_mm` restates it, with
the shape as an argument, and runs it in interpret mode.

Tolerances: 1e-5 of the output's scale in f32 (the same products, summed in
another order). bf16 operands: exact products of the rounded operands, f32
sums, so the same 1e-5. The gradients of `linear`: 1e-4 of each gradient's
scale (f32: sum order only, over up to 200 rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from neuralbody_tpu.models.nn_utils import dense as j_dense
from neuralbody_tpu_torch.ops import dense_kernel as dk

torch.set_num_threads(1)

TOL = 1e-5
GRAD_TOL = 1e-4

# the NeRF MLP's ragged shapes (K = 63, 319, 283; N = 1, 3), small M
RAGGED = [(37, 63, 256), (130, 319, 256), (65, 283, 128), (200, 256, 1),
          (129, 128, 3), (1, 1, 1)]


def _pallas_mm(a, b, block=256):
    M, K = a.shape
    N = b.shape[1]

    def kernel(a_ref, b_ref, o_ref):
        o_ref[...] = jnp.dot(a_ref[...], b_ref[...],
                             preferred_element_type=jnp.float32)
    return pl.pallas_call(
        kernel,
        grid=(M // block,),
        in_specs=[pl.BlockSpec((block, K), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((block, N), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        interpret=True)(a, b)


def _operands(seed, M, K, N):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, K).astype(np.float32),
            rng.randn(K, N).astype(np.float32))


def _close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == np.float32
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("shape", RAGGED + [(1024, 1024, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_dot(shape):
    a, b = _operands(0, *shape)
    ref = jnp.dot(jnp.asarray(a), jnp.asarray(b),
                  preferred_element_type=jnp.float32)
    _close(dk.mm_plain(torch.from_numpy(a), torch.from_numpy(b)), ref)
    # the wrapper takes the plain version for CPU tensors
    before = dk.MM_LAUNCHES, dk.SUM_LAUNCHES
    _close(dk.mm(torch.from_numpy(a), torch.from_numpy(b)), ref)
    assert (dk.MM_LAUNCHES, dk.SUM_LAUNCHES) == before


@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (512, 319, 256),
                                   (256, 63, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_the_pallas_kernel(shape):
    """Kernel #7 itself (the probe's shape first), in interpret mode."""
    a, b = _operands(1, *shape)
    ref = _pallas_mm(jnp.asarray(a), jnp.asarray(b))
    _close(dk.mm_plain(torch.from_numpy(a), torch.from_numpy(b)), ref)


@pytest.mark.parametrize("shape", RAGGED[:5],
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_operands_are_the_f32_product_of_rounded_operands(shape):
    a, b = _operands(2, *shape)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    ref = jnp.dot(jnp.asarray(ta.float().numpy()),
                  jnp.asarray(tb.float().numpy()),
                  preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    out = dk.mm(ta, tb)
    assert out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("needs_dx", [True, False])
@pytest.mark.parametrize("shape", RAGGED[:5],
                         ids=lambda s: "x".join(map(str, s)))
def test_matmul_backward_matches_jax_vjp(shape, needs_dx):
    M, K, N = shape
    a, b = _operands(3, *shape)
    g = np.random.RandomState(4).randn(M, N).astype(np.float32)
    y, vjp = jax.vjp(lambda x, w: jnp.dot(
        x, w, preferred_element_type=jnp.float32), jnp.asarray(a),
        jnp.asarray(b))
    ja, jb = vjp(jnp.asarray(g))
    x = torch.from_numpy(a).requires_grad_(needs_dx)
    w = torch.from_numpy(b).requires_grad_()
    out = dk.matmul(x, w)
    _close(out, y)
    out.backward(torch.from_numpy(g))
    _close(w.grad, jb)
    if needs_dx:
        _close(x.grad, ja)
    else:
        assert x.grad is None


def test_matmul_backward_products_go_through_mm(monkeypatch):
    """One mm forward, one for dw, one for dx, none for a dx nobody needs;
    the backward hands mm transposed views, not copies."""
    calls = []
    real = dk.mm

    def spy(A, B):
        calls.append((tuple(A.shape), A.is_contiguous(),
                      tuple(B.shape), B.is_contiguous()))
        return real(A, B)

    monkeypatch.setattr(dk, "mm", spy)
    a, b = map(torch.from_numpy, _operands(5, 40, 63, 16))
    w = b.clone().requires_grad_()
    dk.matmul(a, w).sum().backward()
    assert calls == [((40, 63), True, (63, 16), True),
                     ((63, 40), False, (40, 16), False)]
    calls.clear()
    x = a.clone().requires_grad_()
    dk.matmul(x, w).square().sum().backward()
    assert calls == [((40, 63), True, (63, 16), True),
                     ((40, 16), True, (16, 63), False),
                     ((63, 40), False, (40, 16), True)]
    with pytest.raises(TypeError):
        dk.matmul(a.bfloat16(), b.bfloat16())


def test_strided_operands_read_in_place():
    a, b = map(torch.from_numpy, _operands(6, 50, 80, 30))
    ref = a[:, 7:70].numpy() @ b[7:70].numpy()
    _close(dk.mm(a[:, 7:70], b[7:70]), ref)
    _close(dk.mm(a.t()[7:70].t(), b.t().contiguous().t()[7:70]), ref)


@pytest.mark.parametrize("shape,want", [
    ((65536, 256, 256), 1),      # a forward layer: 1024 tiles
    ((196608, 1, 256), 1),
    ((319, 256, 196608), 88),    # dW of the skip layer, fine pass
    ((256, 1, 65536), 128),
    ((1024, 1024, 1024), 2),     # the probe's shape: 64 tiles
    ((100, 50, 700), 1),         # too short to split
])
def test_split_plan(shape, want):
    M, N, K = shape
    splits, chunk = dk.split_plan(M, N, K)
    assert splits == want
    assert splits * chunk >= K > (splits - 1) * chunk   # no empty range
    if splits > 1:
        assert chunk % dk.CHUNK == 0 and chunk >= 512
        tiles = -(-M // dk.TILE) * -(-N // dk.TILE)
        # fills the card, unless the shortest range allowed stops it
        assert tiles * splits >= 264 or chunk == 512


def test_mm_refuses_what_the_kernel_does_not_take():
    a, b = map(torch.from_numpy, _operands(7, 8, 6, 4))
    with pytest.raises(TypeError):
        dk.mm(a.half(), b.half())
    with pytest.raises(TypeError):
        dk.mm(a.bfloat16(), b)
    with pytest.raises(ValueError):
        dk.mm(a, b[:5])
    with pytest.raises(ValueError):
        dk.mm(a[None], b)
    with pytest.raises(ValueError):
        dk.mm(a, b.to("meta"))


# -- linear: the bias and the ReLU in the epilogue ----------------------------

@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
@pytest.mark.parametrize("shape", RAGGED[:5],
                         ids=lambda s: "x".join(map(str, s)))
def test_linear_matches_jax_dense(shape, relu):
    """Output, dx, dW and db against jax.vjp of nn_utils.dense (+ relu)."""
    M, K, N = shape
    a, b = _operands(8, *shape)
    rng = np.random.RandomState(9)
    bias = rng.randn(N).astype(np.float32)
    g = rng.randn(M, N).astype(np.float32)

    def layer(x, w, bb):
        y = j_dense({"w": w, "b": bb}, x)
        return jax.nn.relu(y) if relu else y

    y, vjp = jax.vjp(layer, jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias))
    ja, jb, jbias = vjp(jnp.asarray(g))
    x = torch.from_numpy(a).requires_grad_()
    w = torch.from_numpy(b).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    out = dk.linear(x, w, bt, relu)
    _close(out, y)
    _close(dk.linear_plain(x, w, bt, relu), y)
    out.backward(torch.from_numpy(g))
    _close(x.grad, ja, GRAD_TOL)
    _close(w.grad, jb, GRAD_TOL)
    _close(bt.grad, jbias, GRAD_TOL)


def test_linear_products_go_through_mm(monkeypatch):
    """One mm forward with the bias and the ReLU in it, then dx and dw on
    the masked cotangent through transposed views; no dx for an input that
    needs none."""
    calls = []
    real = dk.mm

    def spy(A, B, bias=None, relu=False):
        calls.append((tuple(A.shape), tuple(B.shape), bias is not None, relu))
        return real(A, B, bias, relu)

    monkeypatch.setattr(dk, "mm", spy)
    a, b = map(torch.from_numpy, _operands(10, 40, 63, 16))
    bias = torch.zeros(16).requires_grad_()
    w = b.clone().requires_grad_()
    x = a.clone().requires_grad_()
    out = dk.linear(x, w, bias, relu=True)
    assert calls == [((40, 63), (63, 16), True, True)]
    out.sum().backward()
    assert calls[1:] == [((40, 16), (16, 63), False, False),
                         ((63, 40), (40, 16), False, False)]
    # the cotangent of ones, masked by out > 0
    assert torch.equal(bias.grad, (out > 0).sum(0).float())
    calls.clear()
    dk.linear(a, w, bias).sum().backward()
    assert calls == [((40, 63), (63, 16), True, False),
                     ((63, 40), (40, 16), False, False)]
    with pytest.raises(TypeError):
        dk.linear(a.bfloat16(), b.bfloat16(), bias)


def test_mm_epilogue_on_the_cpu():
    a, b = map(torch.from_numpy, _operands(11, 20, 30, 3))
    bias = torch.tensor([0.5, -100.0, 2.0])
    ref = a.numpy() @ b.numpy() + bias.numpy()
    _close(dk.mm(a, b, bias), ref)
    _close(dk.mm(a, b, bias, relu=True), np.maximum(ref, 0))
    assert (dk.mm(a, b, bias, relu=True)[:, 1] == 0).all()
    with pytest.raises(ValueError):
        dk.mm(a, b, bias[:2])
    with pytest.raises(TypeError):
        dk.mm(a, b, bias.double())


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,want", [
    # a trunk layer's forward, dx and dW: the tensor-core route
    ("fwd_256", ("tf32x3", 1, 256)),
    ("dx_256", ("tf32x3", 1, 256)),
    ("dw_256", ("tf32x3", 131, 1504)),
    # the alpha head (N = 1): rows forward, columns for dW, and its dx
    # (K = 1, N = 256: bound by its output) on the fma loop
    ("fwd_alpha", ("rows", 1, 256)),
    ("dw_alpha", ("cols", 131, 1504)),
    ("dx_alpha", ("fma", 1, 1)),
    # the rgb head (128 -> 3) reads a column slice: still rows
    ("fwd_rgb_slice", ("rows", 1, 128)),
    ("dw_rgb", ("cols", 192, 1024)),
    # neither stride of A is 1: the main route masks it
    ("narrow_strided", ("tf32x3", 1, 100)),
    ("bf16", ("fma", 1, 256)),
])
def test_route_plan(case, want):
    pts = 196608
    x, w, g = _meta((pts, 256)), _meta((256, 256)), _meta((pts, 256))
    g1, w1 = _meta((pts, 1)), _meta((256, 1))
    operands = {
        "fwd_256": (x, w), "dx_256": (g, w.t()), "dw_256": (x.t(), g),
        "fwd_alpha": (x, w1), "dw_alpha": (x.t(), g1),
        "dx_alpha": (g1, w1.t()),
        "fwd_rgb_slice": (_meta((pts, 283))[:, 100:228], _meta((128, 3))),
        "dw_rgb": (_meta((pts, 128)).t(), _meta((pts, 3))),
        "narrow_strided": (_meta((500, 200))[::2, ::2], _meta((100, 3))),
        "bf16": (_meta((pts, 256), torch.bfloat16),
                 _meta((256, 1), torch.bfloat16)),
    }
    assert dk.route_plan(*operands[case]) == want
    route, splits, chunk = want
    K = operands[case][0].shape[1]
    assert splits * chunk >= K > (splits - 1) * chunk
    if splits > 1:
        assert chunk % dk.CHUNK == 0


def test_route_plan_follows_the_switch(monkeypatch):
    x, w1 = _meta((4096, 256)), _meta((256, 1))
    monkeypatch.setattr(dk, "FORCE_MAIN", "tf32x3")
    assert dk.route_plan(x, w1)[0] == "tf32x3"
    assert dk.route_plan(_meta((4096, 1)), w1.t())[0] == "tf32x3"
    monkeypatch.setattr(dk, "FORCE_MAIN", "fma")
    assert dk.route_plan(x, w1)[0] == "fma"
    assert dk.route_plan(x, _meta((256, 256)))[0] == "fma"
    assert dk.route_plan(x.bfloat16(), w1.bfloat16())[0] == "fma"
