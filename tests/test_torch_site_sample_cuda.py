"""The four-level site sampler's kernel (csrc/site_sample.cu:
site_trilinear_kernel) against its plain PyTorch version on the card: at
the latent_xyzc_313 render's level shapes and caps, f32 and bf16 features,
point counts that are not a multiple of the block, padded rays (rd = 0: a
ray's 64 samples at one point), far-off points; then one plan-free image
through eval_step with the kernel against the same image with the plain
sampler. Skips where no NVIDIA GPU is present; run on the card with
`python -m pytest --noconftest tests/test_torch_site_sample_cuda.py -q`.

Tolerance, of the output's scale: 1e-6. The kernel repeats the plain
version's f32 operations in its order (the weights (wz * wy) * wx, the
corners summed z, y, x from +0, no FMA contraction) and reads bf16
features upcast exactly, so equal bits is the design target for both
dtypes (each test reports whether it met it); the limit leaves room only
for a rounding the compiler might change. The image: rgb within 1e-6
(two encodes differ by the atomics of the vertex codes' index_add_,
ops/sparse_conv.scatter_vertex_codes, so equal bits are not expected
there).
"""
import pytest
import torch

from neuralbody_tpu_torch.models import latent_xyzc as lx
from neuralbody_tpu_torch.models.sparse_conv_net import EncoderStatic
from neuralbody_tpu_torch.ops import site_sample_kernel as ssk
from neuralbody_tpu_torch.renderer.renderer import RenderSettings
from neuralbody_tpu_torch.train.step import eval_step
from neuralbody_tpu_torch.utils.synthetic import make_batch

pytestmark = pytest.mark.cuda

# the latent_xyzc_313 render cell's grid and its levels' capacities (the
# benchmark's generated sequence at 5 mm voxels); levels 1-4 are
# (48, 176, 64), (24, 88, 32), (12, 44, 16), (6, 22, 8)
OUT_SH = (96, 352, 128)
CAPS = (16128, 9472, 2816, 768)
TOL = 1e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    ssk.build()
    return torch.device("cuda")


def _levels(seed, dtype, dev):
    """Per level: cap - 40 sites at distinct random voxels, the rest of the
    rows padding that the index volume never names."""
    g = torch.Generator().manual_seed(seed)
    feats, ivols = [], []
    for lvl, (C, cap) in enumerate(zip(ssk.CHANNELS, CAPS), 1):
        sh = tuple(s // 2 ** lvl for s in OUT_SH)
        n_vox = sh[0] * sh[1] * sh[2]
        n = min(cap - 40, n_vox)
        ivol = torch.full((n_vox,), cap, dtype=torch.int32)
        ivol[torch.randperm(n_vox, generator=g)[:n]] = torch.arange(
            n, dtype=torch.int32)
        feats.append(torch.randn((cap, C), generator=g).to(dtype).to(dev))
        ivols.append(ivol.reshape(sh).to(dev))
    return feats, ivols


def _points(seed, n_rays, dev, pad_rays=0, far=False):
    """64 samples along each of n_rays segments through and around the grid
    (full-res voxel coords), the last pad_rays of them padded (every sample
    at the ray's origin); with far, a few far-off points."""
    g = torch.Generator().manual_seed(seed + 1)
    hi = torch.tensor(OUT_SH, dtype=torch.float32)
    a = torch.rand((n_rays, 1, 3), generator=g) * (hi + 8) - 4
    b = torch.rand((n_rays, 1, 3), generator=g) * (hi + 8) - 4
    b[n_rays - pad_rays:] = a[n_rays - pad_rays:]
    s = torch.linspace(0, 1, 64).reshape(1, 64, 1)
    pts = (a + (b - a) * s).reshape(-1, 3)
    if far:
        pts[:4] = torch.tensor([1e12, -1e12, 3e9, -3e9])[:, None]
        pts[4] = torch.tensor([-1e-3, 2.0, 2.0])
    return pts.contiguous().to(dev)


def _compare(out, ref):
    scale = ref.abs().max().item()
    assert scale > 0
    err = (out - ref).abs().max().item()
    same = torch.equal(out.view(torch.int32), ref.view(torch.int32))
    print(f"max |kernel - plain| = {err:.3g} of scale {scale:.3g}; "
          f"equal bits: {same}")
    assert err <= TOL * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("points", [(2048, 16, False), (37, 3, True),
                                    (2048 + 5, 0, True)],
                         ids=["chunk", "small", "ragged"])
def test_kernel_matches_plain(dev, dtype, points):
    """One launch for the four levels against site_trilinear_plain; the
    small and ragged cases drop 3 points, so that N is not a multiple of
    the 8 points a block."""
    n_rays, pad, far = points
    feats, ivols = _levels(0, dtype, dev)
    dhw = _points(0, n_rays, dev, pad, far)
    if n_rays % 8:
        dhw = dhw[:-3].contiguous()
    before = (ssk.LAUNCHES, ssk.PLAIN_CALLS)
    out = ssk.site_trilinear(feats, ivols, dhw, OUT_SH, CAPS)
    torch.cuda.synchronize()
    assert (ssk.LAUNCHES, ssk.PLAIN_CALLS) == (before[0] + 1, before[1])
    ref = ssk.site_trilinear_plain(feats, ivols, dhw, OUT_SH, CAPS)
    assert out.shape == ref.shape == (dhw.shape[0], 352)
    _compare(out, ref)


def test_empty_and_second_call(dev):
    """No points: an empty output and no launch. Two calls on the same
    inputs give equal bits."""
    feats, ivols = _levels(1, torch.float32, dev)
    before = ssk.LAUNCHES
    empty = ssk.site_trilinear(feats, ivols, torch.zeros((0, 3), device=dev),
                               OUT_SH, CAPS)
    assert empty.shape == (0, 352) and ssk.LAUNCHES == before
    dhw = _points(1, 2048, dev)
    a = ssk.site_trilinear(feats, ivols, dhw, OUT_SH, CAPS)
    b = ssk.site_trilinear(feats, ivols, dhw, OUT_SH, CAPS)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_gradient_keeps_the_plain_path(dev):
    """interpolate_site_features with features that require grad takes the
    plain autograd expression on the card: no launch, and the gradient
    reaches the features."""
    feats, ivols = _levels(2, torch.float32, dev)
    feats = [f.requires_grad_() for f in feats]
    static = lx.ModelStatic(encoder=EncoderStatic(
        out_sh=OUT_SH, site_caps=(1,) + CAPS))
    dhw = _points(2, 64, dev)
    before = (ssk.LAUNCHES, ssk.PLAIN_CALLS)
    out = lx.interpolate_site_features(feats, ivols, dhw, static)
    assert (ssk.LAUNCHES, ssk.PLAIN_CALLS) == (before[0], before[1] + 1)
    out.sum().backward()
    assert all(f.grad is not None and f.grad.abs().sum().item() > 0
               for f in feats)


def test_eval_step_image(dev, monkeypatch):
    """One plan-free image (8192 rays, 4 chunks of 2048 x 64 samples)
    through eval_step: one launch a chunk and no plain call, and the same
    image with the plain sampler on the card: rgb within 1e-6."""
    batch, static = make_batch(n_rays=8192, n_verts=6890, voxel_size=0.005,
                               seed=7)
    params, _ = lx.init(torch.Generator().manual_seed(7), num_train_frame=1,
                        device=dev)
    params["alpha_fc"]["b"] += 1.0   # random weights are empty otherwise
    settings = RenderSettings(
        model=lx.ModelStatic(encoder=EncoderStatic(
            out_sh=static["out_sh"], site_caps=static["site_caps"])),
        voxel_size=(0.005,) * 3, n_samples=64, chunk_rays=2048,
        site_interp=True)
    before = (ssk.LAUNCHES, ssk.PLAIN_CALLS)
    ret = eval_step(params, batch, settings, device=dev)
    torch.cuda.synchronize()
    assert (ssk.LAUNCHES, ssk.PLAIN_CALLS) == (before[0] + 4, before[1])
    monkeypatch.setattr(ssk, "site_trilinear", ssk.site_trilinear_plain)
    ref = eval_step(params, batch, settings, device=dev)
    assert ssk.LAUNCHES == before[0] + 4
    assert ssk.PLAIN_CALLS == before[1] + 4
    rgb, want = ret["rgb_map"], ref["rgb_map"]
    assert want.abs().max().item() > 0
    err = (rgb - want).abs().max().item()
    print(f"rgb: max |kernel - plain| = {err:.3g}; equal bits: "
          f"{torch.equal(rgb, want)}")
    assert err <= TOL
