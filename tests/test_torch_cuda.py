"""CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (they build the kernels) and
skip without one. They import no JAX, so they also run where JAX is not
installed; run them without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import pytest
import torch

from v2e2v_tpu_torch.models.cista import CistaConfig, cista_sequence, init_cista_lstc
from v2e2v_tpu_torch.ops.cuda.ista import ista_loop, ista_loop_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """Skip without a card; float32 convs and matmuls in full float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _inputs(b, h, w, c, device, dtype, seed=0):
    """Activations ~ N(0, 0.5^2); weights, biases and Lambda drawn as
    ``init_cista_lstc`` draws them (torch's default conv init)."""
    g = torch.Generator().manual_seed(seed)

    def u(bound, *shape):
        return torch.empty(*shape).uniform_(-bound, bound, generator=g).to(device)

    bd, bp = (9 * 2 * c) ** -0.5, (9 * c) ** -0.5
    act = [(0.5 * torch.randn(b, h, w, k, generator=g)).to(device, dtype) for k in (c, 2 * c)]
    return (*act, u(bd, 3, 3, 2 * c, c), u(bd, c), u(bp, 3, 3, c, 2 * c), u(bp, 2 * c),
            0.001 * torch.rand(2 * c, generator=g).to(device))


# (B, H, W, C, depth): tiles that fit, ragged tiles, the 2x2 minimum, the
# flagship's C = 64 and depth 5
SHAPES = [(2, 16, 32, 8, 3), (3, 13, 21, 16, 2), (1, 2, 2, 8, 1), (2, 9, 17, 64, 5)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_ista_kernel_matches_plain(card, shape, dtype, tol):
    *dims, depth = shape
    args = _inputs(*dims, card, dtype)
    before = ista_loop.launches
    got = ista_loop(*args, depth=depth)
    torch.cuda.synchronize()
    assert ista_loop.launches - before == 2 * depth
    want = ista_loop_plain(*args, depth=depth)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_ista_kernel_leaves_its_inputs_alone(card):
    args = _inputs(2, 8, 16, 8, card, torch.float32)
    copies = [a.clone() for a in args]
    ista_loop(*args, depth=3)
    torch.cuda.synchronize()
    for a, c in zip(args, copies):
        assert torch.equal(a, c)


def test_ista_kernel_refuses_what_it_cannot_run(card):
    for c in (12, 128):
        args = list(_inputs(1, 8, 8, c, card, torch.float32))
        with pytest.raises(ValueError, match="C % 8 == 0 and C <= 64"):
            ista_loop(*args, depth=1)
    args = list(_inputs(1, 8, 8, 8, card, torch.float32))
    args[0] = args[0].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ista_loop(*args, depth=1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_model_with_kernel_matches_plain(card, dtype, tol):
    cfg = CistaConfig(image_dim=(32, 48), base_channels=16, depth=3, num_bins=5)
    sd = {k: v.to(dtype) for k, v in
          init_cista_lstc(torch.Generator().manual_seed(0), cfg, device=card).items()}
    vox = torch.randn(3, 2, 32, 48, 5, generator=torch.Generator().manual_seed(1)).to(card, dtype)
    got, _ = cista_sequence(sd, cfg, vox)
    want, _ = cista_sequence(sd, dataclasses.replace(cfg, ista_impl="plain"), vox)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_front_end_on_card_matches_cpu(card):
    from v2e2v_tpu_torch.ops.voxel import event_preprocess, events_to_voxel_grid

    g = torch.Generator().manual_seed(2)
    cap, n, h, w = 4096, 3000, 60, 80
    t = torch.sort(torch.rand(cap, generator=g, dtype=torch.float64) * 0.03).values
    ev = (t, torch.randint(0, w, (cap,), generator=g), torch.randint(0, h, (cap,), generator=g),
          torch.randint(0, 2, (cap,), generator=g))
    kw = dict(num_bins=5, width=w, height=h)
    want = event_preprocess(events_to_voxel_grid(*ev, n, **kw))
    got = event_preprocess(events_to_voxel_grid(*(a.to(card) for a in ev), n, **kw))
    # index_add_ on the card sums with atomics in no fixed order
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
