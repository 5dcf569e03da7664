"""The flow-warp loss's routing on CPU tensors (``train/losses.py::
warp_images``, ``flow_warp_loss``): ``"auto"`` and ``"plain"`` take the
plain route, launch no kernel and count nothing; ``"cuda"`` and the
kernels' wrappers (``ops/cuda_warp.py``) refuse CPU tensors before any
build. The kernels themselves are held against the plain route on the card
(``tests/test_torch_gpu.py``). Imports no JAX."""

import numpy as np
import pytest
import torch

from mobgs_tpu_torch.ops import cuda_warp
from mobgs_tpu_torch.train import losses
from mobgs_tpu_torch.utils import observability as obs

E, W, H = 3, 24, 16


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    pix = np.stack([gx, gy], -1)
    arrays = [rng.random((H, W, 3)), rng.random((E, H, W, 3)), rng.random((E, H, W)),
              rng.random((H, W)), pix + 3 * rng.standard_normal((E, H, W, 2)),
              pix + 3 * rng.standard_normal((E, H, W, 2))]
    return [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in arrays]


@pytest.fixture
def counting():
    obs.tracing(spans=False, counters=True)
    obs.reset()
    yield
    obs.tracing(False)
    obs.reset()


@pytest.fixture
def no_kernel(monkeypatch):
    def refuse(*args):
        raise AssertionError("the kernels' route was taken for CPU tensors")
    monkeypatch.setattr(cuda_warp.WarpCuda, "apply", refuse)


@pytest.mark.parametrize("backend", ("auto", "plain"))
def test_flow_warp_loss_on_cpu_takes_the_plain_route(backend, counting, no_kernel):
    xs = _loss_inputs()
    launches = dict(cuda_warp.launches)
    got = losses.flow_warp_loss(*xs, W, H, backend=backend)
    got_grads = torch.autograd.grad(got, xs)
    want = losses.flow_warp_loss(*xs, W, H)
    want_grads = torch.autograd.grad(want, xs)
    assert torch.equal(got, want) and float(got.detach()) > 0
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)
    assert obs.report()["counters"] == {}
    assert cuda_warp.launches == launches


def test_warp_images_routes_by_device_and_backend(no_kernel):
    xs = _loss_inputs(1)
    imgs = torch.cat([xs[0][None].expand(E, H, W, 3), xs[1]]).detach()
    coords = torch.cat([xs[4], xs[5]]).detach()
    plain = losses._WarpImages.apply(imgs, coords, W, H)
    assert torch.equal(losses.warp_images(imgs, coords, W, H), plain)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        losses.warp_images(imgs, coords, W, H, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        losses.warp_images(imgs, coords, W, H, backend="triton")


@pytest.mark.parametrize("entry", ("warp_fwd", "warp_bwd"))
def test_warp_wrappers_refuse_cpu_tensors(entry, monkeypatch):
    def no_build(name):
        raise AssertionError("a refused operand reached the library")
    monkeypatch.setattr(cuda_warp.cuda_raster, "_library", no_build)
    imgs = torch.zeros((2, H, W, 3))
    coords = torch.zeros((2, H, W, 2))
    args = (imgs, coords, imgs) if entry == "warp_bwd" else (imgs, coords)
    with pytest.raises(ValueError, match="not CUDA"):
        getattr(cuda_warp, entry)(*args, W, H)
