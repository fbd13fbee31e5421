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
from v2e2v_tpu_torch.ops.cuda import core as k2
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
# flagship's C = 64 and depth 5, and C = 128 (the P conv's 256 output
# channels in two chunks)
SHAPES = [(2, 16, 32, 8, 3), (3, 13, 21, 16, 2), (1, 2, 2, 8, 1), (2, 9, 17, 64, 5),
          (2, 9, 17, 128, 2)]


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
    args = list(_inputs(1, 8, 8, 12, card, torch.float32))
    with pytest.raises(ValueError, match="C % 8 == 0"):
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


def _core_args(b, h, w, c, depth, device, dtype, seed=0):
    """K2's taps from ``init_cista_lstc`` weights, x1 ~ N(0, 0.5^2) and the
    recurrent state ~ N(0, 0.3^2)."""
    cfg = CistaConfig(image_dim=(2 * h, 2 * w), base_channels=c, depth=depth)
    sd = init_cista_lstc(torch.Generator().manual_seed(seed), cfg, device=device)
    g = torch.Generator().manual_seed(seed + 1)
    x1 = (0.5 * torch.randn(b, h, w, c, generator=g)).to(device, dtype)
    state = [(0.3 * torch.randn(b, h, w, k, generator=g)).to(device, dtype)
             for k in (2 * c, 2 * c, c, c)]
    return k2.core_taps(sd, dtype), x1, *state


# (B, H, W, C, depth): ragged tiles, the 2x2 minimum, and the flagship pool's
# core (B = 8, 90x120, C = 64, depth 5)
CORE_SHAPES = [(2, 13, 21, 16, 2), (1, 2, 2, 8, 1), (8, 90, 120, 64, 5)]


@pytest.mark.parametrize("shape", CORE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_core_kernel_matches_plain(card, shape, dtype, tol):
    *dims, depth = shape
    args = _core_args(*dims, depth, card, dtype)
    copies = [a.clone() for a in args[1:]]
    before = k2.cista_core.launches
    got = k2.cista_core(*args, depth=depth)
    torch.cuda.synchronize()
    assert k2.cista_core.launches - before == k2.launches_per_call(depth) == 7 + 2 * depth
    want = k2.cista_core_plain(*args, depth=depth)
    assert got[0] is got[3]
    for name, g, w_ in zip(("rec_h", "z", "cell", "dg_h", "dg_c"), got, want):
        assert g.dtype == dtype and g.shape == w_.shape, name
        torch.testing.assert_close(g.float(), w_.float(), atol=tol, rtol=tol, msg=name)
    for a, c in zip(args[1:], copies):  # new tensors hold the outputs
        assert torch.equal(a, c)


def test_core_kernel_bf16_taps_without_their_layout_match(card):
    """bfloat16 taps from core_taps carry the tensor-core layout; float32
    taps with bfloat16 activations are cast and laid out on the call: both
    give the same result."""
    taps, *inputs = _core_args(2, 13, 21, 16, 2, card, torch.bfloat16)
    assert set(k2.TC_KEYS) <= set(taps)
    f32_taps = k2.core_taps(init_cista_lstc(
        torch.Generator().manual_seed(0),
        CistaConfig(image_dim=(26, 42), base_channels=16, depth=2), device=card), torch.float32)
    assert not set(k2.TC_KEYS) & set(f32_taps)
    got = k2.cista_core(f32_taps, *inputs, depth=2)
    want = k2.cista_core(taps, *inputs, depth=2)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_core_kernel_raises_and_never_falls_back(card, monkeypatch):
    """A failed build or a refused launch raises; the plain version is never
    taken for a CUDA tensor."""
    from v2e2v_tpu_torch.ops.cuda import _lib

    args = _core_args(1, 8, 8, 8, 1, card, torch.float32)
    real = _lib.load()

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(k2, "cista_core_plain", no_plain)

    def no_build():
        raise RuntimeError("nvcc failed (1)")

    monkeypatch.setattr(_lib, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        k2.cista_core(*args, depth=1)

    class Refusing:
        class lib:
            @staticmethod
            def v2e_core_conv3x3(*a):
                return 1  # cudaErrorInvalidValue

        check = staticmethod(real.check)

    monkeypatch.setattr(_lib, "load", lambda: Refusing)
    with pytest.raises(RuntimeError, match="core_conv3x3 launch failed"):
        k2.cista_core(*args, depth=1)

    # a grid the card refuses: B > 65535 blocks along grid axis y
    monkeypatch.setattr(_lib, "load", lambda: real)
    big = _core_args(65536, 2, 2, 8, 1, card, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        k2.cista_core(*big, depth=1)
    with pytest.raises(ValueError, match="C % 8 == 0"):
        k2.cista_core(*_core_args(1, 4, 4, 12, 1, card, torch.float32), depth=1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_model_and_pool_with_core_kernel_match_plain_core(card, dtype, tol):
    """cista_sequence and StreamPool with core_impl='cuda' against
    core_impl='plain' on the same weights and voxel grids."""
    from v2e2v_tpu_torch.serving import StreamPool

    cfg = CistaConfig(image_dim=(32, 48), base_channels=16, depth=3, num_bins=5,
                      core_impl="cuda")
    plain = dataclasses.replace(cfg, core_impl="plain")
    sd = init_cista_lstc(torch.Generator().manual_seed(0), cfg, device=card)
    vox = torch.randn(3, 2, 32, 48, 5, generator=torch.Generator().manual_seed(1)).to(card, dtype)
    sd_dt = {k: v.to(dtype) for k, v in sd.items()}
    before = k2.cista_core.launches
    got, _ = cista_sequence(sd_dt, cfg, vox)
    assert k2.cista_core.launches - before == 3 * k2.launches_per_call(3)
    want, _ = cista_sequence(sd_dt, plain, vox)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    pools = [StreamPool(c, sd, capacity=3, dtype=dtype) for c in (cfg, plain)]
    ids = [[p.attach() for _ in range(3)] for p in pools]
    for step, active in enumerate(([0, 1, 2], [1], [0, 2])):
        outs = [p.step({i[a]: vox[step, a % 2] for a in active}, fetch=False)
                for p, i in zip(pools, ids)]
        for a in active:
            torch.testing.assert_close(outs[0][ids[0][a]].float(), outs[1][ids[1][a]].float(),
                                       atol=tol, rtol=tol)


# The convs of K1 and K2 through both C entry points, in float32 (the FFMA
# conv of csrc/conv3x3.cuh) and bfloat16 (the tensor-core conv of
# csrc/conv3x3_tc.cuh): (epilogue, entry, B, H, W, cin_a, cin_b, cout).
# Ragged tiles (H not a multiple of 8 or 16, W not of 8, 16 or 32), the 2x2
# minimum, B = 1 and 8, the flagship's convs at 90x120 (B = 8: the float32
# conv's 8x32 tile) and the CLIs' D and P convs at B = 1 (its 8x8 and 8x16
# tiles), C = 8, 16 and 24 (K chunks not a multiple of 16 channels:
# zero-filled tails), cout 64, 128 and 256 (several output-channel chunks on
# grid axis z), a cout below the block's 64 channels (masked), and the concat
# convs with and without their second input.
TC_CASES = [
    ("D", "ista", 1, 9, 13, 16, 0, 8), ("P", "ista", 8, 17, 33, 8, 0, 16),
    ("D", "ista", 8, 90, 120, 128, 0, 64), ("P", "ista", 8, 90, 120, 64, 0, 128),
    ("D", "ista", 1, 90, 120, 128, 0, 64), ("P", "ista", 1, 90, 120, 64, 0, 128),
    ("D", "ista", 2, 2, 2, 16, 0, 8),
    ("D", "core", 1, 17, 33, 32, 0, 16), ("P", "core", 2, 9, 13, 16, 0, 32),
    ("PRE", "core", 8, 90, 120, 64, 128, 256), ("PRE", "core", 1, 17, 33, 64, 0, 128),
    ("PRE", "core", 2, 9, 13, 8, 8, 32), ("PRE", "core", 1, 9, 13, 64, 0, 256),
    ("RELU", "core", 8, 90, 120, 128, 0, 64), ("RELU", "core", 1, 17, 33, 24, 0, 24),
    ("OUT_GATE", "core", 8, 90, 120, 128, 128, 128), ("OUT_GATE", "core", 1, 9, 13, 16, 0, 16),
    ("OUT_GATE", "core", 2, 17, 33, 8, 16, 64),
]
_EPI = {"D": 0, "P": 1, "PRE": 2, "RELU": 3, "OUT_GATE": 4}


def _conv_reference(epi, xs, ws, bias, other, lam, dtype):
    """float64 reflect conv of the inputs and taps (their sum is exact to
    float32 rounding), then the epilogue in float32 as the kernel does it,
    cast to ``dtype`` (float32 for the pre-activations)."""
    v = bias.double()
    for x, w in zip(xs, ws):
        xp = torch.nn.functional.pad(x.double().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        w_oihw = w.double().reshape(3, 3, *w.shape[1:]).permute(3, 2, 0, 1)
        v = v + torch.nn.functional.conv2d(xp, w_oihw).permute(0, 2, 3, 1)
    v = v.float()
    if epi == "PRE":
        return v
    if epi == "D":
        res = other.float() - v
    elif epi == "P":
        y = v + other.float()
        res = torch.relu(y - lam) - torch.relu(-y - lam)
    elif epi == "RELU":
        res = torch.relu(v)
    else:
        res = torch.sigmoid(v) * torch.tanh(other)
    return res.to(dtype)


@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tensor_core_conv_matches_reference(card, dtype, case):
    """Each epilogue of the conv of ``dtype`` against a float64 conv of the
    same inputs and taps. Float32 (FFMA): within 2e-5 + 2e-5 |ref| (float32
    sums of up to 9 x 384 = 3,456 products, here in another order: about
    sqrt(3456) x 6e-8 of the terms' O(1) scale, with room). Bfloat16: float32
    outputs (pre-activations) within 1e-3 + 1e-3 |ref| (float32 sums of
    bf16-rounded products in another order), bf16 outputs within 1e-2 +
    1e-2 |ref| (one bf16 ulp is 2^-8 relative, and a sum that differs in its
    last float32 bits may round to the neighbouring bf16 value)."""
    from v2e2v_tpu_torch.ops.cuda import _lib
    from v2e2v_tpu_torch.ops.cuda.conv_tc import simt_taps, wgmma_taps

    epi, entry, b, h, w, cin_a, cin_b, cout = case
    lib = _lib.load()
    g = torch.Generator().manual_seed(sum(case[2:]))

    def act(c):
        return (0.5 * torch.randn(b, h, w, c, generator=g)).to(card, dtype)

    def taps(cin):
        bound = (9 * (cin_a + cin_b)) ** -0.5
        return torch.empty(9, cin, cout).uniform_(-bound, bound, generator=g).to(card, dtype)

    xs = [act(cin_a)] + ([act(cin_b)] if cin_b else [])
    ws = [taps(cin_a)] + ([taps(cin_b)] if cin_b else [])
    bias = (0.1 * torch.randn(cout, generator=g)).to(card)
    lam = (0.05 * torch.rand(cout, generator=g)).to(card)
    other = {"D": act(cout), "P": act(cout), "OUT_GATE": torch.randn(b, h, w, cout, generator=g,
                                                                     device="cpu").to(card)}.get(epi)
    out = torch.empty(b, h, w, cout, device=card,
                      dtype=torch.float32 if epi == "PRE" else dtype)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [None if t is None else t.data_ptr() for t in (other, lam if epi == "P" else None)]
    code = 0 if dtype == torch.float32 else 1
    laid = [(simt_taps if code == 0 else wgmma_taps)(t) for t in ws]  # the kernel's smem order
    if entry == "ista":
        err = lib.lib.v2e_ista_conv3x3(code, _EPI[epi], xs[0].data_ptr(), laid[0].data_ptr(),
                                       bias.data_ptr(), ptr[0], ptr[1], out.data_ptr(),
                                       b, h, w, cin_a, cout, stream)
    else:
        err = lib.lib.v2e_core_conv3x3(
            code, _EPI[epi], xs[0].data_ptr(), laid[0].data_ptr(), cin_a,
            xs[1].data_ptr() if cin_b else None, laid[1].data_ptr() if cin_b else None, cin_b,
            bias.data_ptr(), ptr[0], ptr[1], out.data_ptr(), b, h, w, cout, stream)
    lib.check(err, f"{dtype} conv launch")
    torch.cuda.synchronize()
    want = _conv_reference(epi, xs, ws, bias, other, lam, out.dtype)
    tol = 2e-5 if code == 0 else 1e-3 if epi == "PRE" else 1e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tensor_core_conv_refuses_misaligned_views(card, dtype):
    """Both convs copy 16-byte rows with cp.async: a view that does not start
    on a 16-byte boundary is refused by the wrappers, not read crookedly."""
    args = list(_inputs(1, 8, 8, 8, card, dtype))

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=card, dtype=t.dtype)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    for i in (0, 1):
        bad = list(args)
        bad[i] = shifted(args[i])
        with pytest.raises(ValueError, match="16-byte boundary"):
            ista_loop(*bad, depth=1)
    core = list(_core_args(1, 8, 8, 8, 1, card, dtype))
    core[3] = shifted(core[3])  # cell
    with pytest.raises(ValueError, match="16-byte boundary"):
        k2.cista_core(*core, depth=1)
    ista_loop(*args, depth=1)  # the aligned originals run


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


def _k3_inputs(b, h, w, mi, shot, gate_on, device, seed=0, consistent=True):
    """Inputs of one frame pair's iteration loop. ``consistent`` sets
    ``num_iters`` as the emulator does (the row's largest count, in [1, mi]);
    otherwise rows get fewer iterations than their counts, as in
    tests/test_pallas_emulator.py."""
    g = torch.Generator().manual_seed(seed)
    counts = torch.randint(0, 7, (b, h, w), generator=g, dtype=torch.int32)
    pol = torch.randint(-1, 2, (b, h, w), generator=g).to(torch.float32)
    if consistent:
        num_iters = counts.amax(dim=(1, 2)).clamp(1, mi)
    else:
        num_iters = torch.randint(1, 7, (b,), generator=g, dtype=torch.int32)
    ts_step = torch.full((b,), 4.0) / num_iters.to(torch.float32)
    t = dict(
        event_counts=counts, pol=pol, timestamp_mem=-torch.rand(b, h, w, generator=g),
        tr_frames=torch.full((b, h, w), 0.7),
        one_minus_on_prob=1.0 - 0.05 * torch.rand(b, h, w, generator=g),
        off_prob=0.05 * torch.rand(b, h, w, generator=g),
        rand01=torch.rand(mi, b, h, w, generator=g) if shot else None,
        seed=None, ts_step=ts_step, num_iters=num_iters,
        gate=torch.full((b,), gate_on, dtype=torch.bool), tf_base=1.0,
    )
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in t.items()}


# (B, H, W, max_iters, consistent num_iters): a square and a non-square plane,
# and the Pallas test's rows with fewer iterations than counts
K3_SHAPES = [(2, 16, 16, 8, True), (3, 13, 37, 32, True), (2, 16, 24, 8, False)]


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
@pytest.mark.parametrize("shot", [True, False], ids=["shot", "noshot"])
@pytest.mark.parametrize("gate_on", [True, False], ids=["gate", "nogate"])
def test_emulator_iters_kernel_matches_plain(card, shape, shot, gate_on):
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters, emulator_iters_plain

    b, h, w, mi, consistent = shape
    x = _k3_inputs(b, h, w, mi, shot, gate_on, card, consistent=consistent)
    kw = dict(num_bins=5, max_iters=mi, shot=shot)
    before = emulator_iters.launches
    voxel, mem, final = emulator_iters(**x, **kw)
    torch.cuda.synchronize()
    assert emulator_iters.launches - before == 1
    want = emulator_iters_plain(**x, **kw)
    assert torch.equal(final, want[2]) and torch.equal(mem, want[1])
    # the same terms in the same order, rounded alike: equal in practice
    torch.testing.assert_close(voxel, want[0], atol=1e-5, rtol=0)


def test_emulator_iters_internal_rng(card):
    """Internal Philox: the kernel equals its plain version, a seed repeats,
    and with no threshold events the shot-event total is Binomial(n, p)."""
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters, emulator_iters_plain

    b, h, w, mi, p = 2, 45, 60, 32, 0.01
    x = _k3_inputs(b, h, w, mi, True, False, card)
    x |= dict(event_counts=torch.zeros_like(x["event_counts"]),
              pol=torch.where(x["pol"] >= 0, 1.0, -1.0),
              one_minus_on_prob=torch.full_like(x["pol"], 1.0 - p),
              off_prob=torch.full_like(x["pol"], p), rand01=None,
              num_iters=torch.full((b,), mi, dtype=torch.int32, device=card),
              seed=torch.tensor([3, 2**40 + 5], dtype=torch.int64, device=card))
    kw = dict(num_bins=5, max_iters=mi, shot=True, internal_rng=True)
    got = emulator_iters(**x, **kw)
    again = emulator_iters(**x, **kw)
    want = emulator_iters_plain(**x, **kw)
    for g, a, w_ in zip(got, again, want):
        assert torch.equal(g, a) and torch.equal(g, w_)
    n = b * h * w * mi
    total = int(got[2].sum())
    assert abs(total - n * p) < 5 * (n * p * (1 - p)) ** 0.5, (total, n * p)


def test_emulator_iters_refuses_what_it_cannot_run(card):
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters

    x = _k3_inputs(2, 8, 8, 4, True, True, card)
    with pytest.raises(ValueError, match="num_bins"):
        emulator_iters(**x, num_bins=17, max_iters=4, shot=True)
    x["pol"] = x["pol"].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        emulator_iters(**x, num_bins=5, max_iters=4, shot=True)


@pytest.mark.parametrize("explicit_shot,refractory", [(True, 0.001), (False, 0.001), (False, 0.0)],
                         ids=["explicit", "internal", "internal-nogate"])
def test_v2e2v_with_kernels_matches_plain(card, explicit_shot, refractory):
    """Two packs through K3 and K1 against the plain versions, with the shot
    uniforms drawn from one card generator seed (explicit) or made by Philox
    from its seeds (internal, the default on the card): equal event counts,
    voxel grids and reconstructions within 1e-4. K3 runs with and without
    the refractory gate."""
    from v2e2v_tpu_torch.models.emulator import EmulatorConfig, GeneratorNoise
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig, v2e2v_forward
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters

    h, w, n, b = 32, 48, 6, 2
    emu = EmulatorConfig(pos_thres=0.6, neg_thres=0.6, sigma_thres=0.03, pl=1.5, ps=0.5,
                         cutoff_hz=200.0, ql=1.0, qs=0.0, refractory_period_s=refractory,
                         leak_rate_hz=0.1, shot_noise_rate_hz=100.0)
    cfg = V2E2VConfig(CistaConfig(image_dim=(h, w), base_channels=16, depth=2, num_bins=5), emu)
    plain = V2E2VConfig(dataclasses.replace(cfg.cista, ista_impl="plain"),
                        dataclasses.replace(emu, iters_impl="plain"))
    sd = init_cista_lstc(torch.Generator().manual_seed(0), cfg.cista, device=card)
    g = torch.Generator().manual_seed(1)
    base = 30 + 190 * torch.rand(b, 1, h, w, generator=g)
    rate = torch.rand(b, 1, h, w, generator=g) - 0.5
    i = torch.arange(2 * n, dtype=torch.float32).reshape(1, -1, 1, 1)
    frames = (base * torch.exp(rate * torch.sin(0.7 * i))).clamp(0, 255).to(card)
    ts = (0.004 * i.reshape(1, -1)).expand(b, -1).to(card)

    def run(c):
        noise = GeneratorNoise(torch.Generator(device=card).manual_seed(2), explicit_shot)
        state, outs = None, []
        for p in range(2):
            out, state = v2e2v_forward(sd, c, frames[:, p * n:(p + 1) * n],
                                       ts[:, p * n:(p + 1) * n], state, noise)
            outs.append(out)
        return outs

    mode = "explicit" if explicit_shot else "internal"
    before = emulator_iters.launches_by_shot[mode]
    got = run(cfg)
    assert emulator_iters.launches_by_shot[mode] - before == 2 * (n - 1)
    want = run(plain)
    for a, b_ in zip(got, want):
        assert int(a.num_events) == int(b_.num_events) > 0
        torch.testing.assert_close(a.event_voxel_grids, b_.event_voxel_grids, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(a.reconstruction, b_.reconstruction, atol=1e-4, rtol=1e-4)


def test_emulate_pack_never_waits_for_the_card(card):
    """The pair loop issues its work without synchronising with the host."""
    from v2e2v_tpu_torch.models.emulator import EmulatorConfig, emulate_pack

    cfg = EmulatorConfig(pos_thres=0.6, neg_thres=0.6, refractory_period_s=0.001,
                         shot_noise_rate_hz=100.0, cutoff_hz=200.0, qs=0.0)
    g = torch.Generator(device=card).manual_seed(0)
    frames = 30 + 190 * torch.rand(2, 6, 16, 24, device=card, generator=g)
    ts = (0.004 * torch.arange(6, device=card, dtype=torch.float32)).expand(2, 6)
    _, _, state = emulate_pack(cfg, None, frames, ts, g)  # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        voxel, n_events, _ = emulate_pack(cfg, state, frames.flip(1), ts + 0.02, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert voxel.shape == (2, 16, 24, 5) and int(n_events) > 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_e2v_cli_through_k1_matches_plain_ista(card, tmp_path, dtype, tol):
    """The evaluation CLI on a small dataset written without PIL
    (data/synthetic.py): every reconstruction launches K1 2 x depth times;
    at every call K1's output equals its plain version on the same inputs
    (batch 1), and at every step the reconstruction and the state (z, which
    K1 makes, the cell and the Dg ConvLSTM's h and c) equal the same run's
    with the plain ISTA. Random-init reconstructions are nearly constant,
    so the images alone would not show a wrong K1."""
    from v2e2v_tpu_torch.cli import test_e2v as cli
    from v2e2v_tpu_torch.data.synthetic import write_dataset
    from v2e2v_tpu_torch.models import cista as cista_mod
    from v2e2v_tpu_torch.utils.configs import set_configs

    h, w, c, depth = 32, 48, 16, 3
    write_dataset(tmp_path / "data", 0, 2, 7, h, w, (400, 900))
    cfg = CistaConfig(image_dim=(h, w), base_channels=c, depth=depth)
    torch.save({"epoch": 0, "v2e_params": None,
                "state_dict": init_cista_lstc(torch.Generator().manual_seed(0), cfg, "cpu")},
               tmp_path / "model.pth.tar")
    runs, k1_calls = {}, []

    def k1_checked(*a, **k):
        got = ista_loop(*a, **k)
        k1_calls.append((got, ista_loop_plain(*a, **k)))
        return got

    for impl in ("cuda", "plain"):
        parser = cli.argparse.ArgumentParser()
        set_configs(parser)
        cfgs = parser.parse_args([
            "--path_to_test_model", str(tmp_path / "model.pth.tar"), "--path_to_test_data",
            str(tmp_path / "data"), "--image_dim", str(h), str(w), "-c", str(c), "-d", str(depth),
            "--num_events", "500", "--precision", {torch.float32: "float32",
                                                   torch.bfloat16: "bfloat16"}[dtype],
            "-o", str(tmp_path / impl)])
        rec = cli.Reconstructor(cfgs, card)
        if impl == "plain":
            rec.cfg = dataclasses.replace(rec.cfg, ista_impl="plain")
        steps, step = [], cli.make_step(rec.cfg, dtype)

        def recorded(*a, step=step, steps=steps):
            out, st = step(*a)
            steps.append((out, st))
            return out, st

        rec.step = recorded
        before = ista_loop.launches
        saved = cista_mod.ista_loop
        cista_mod.ista_loop = k1_checked
        try:
            rec.run()
        finally:
            cista_mod.ista_loop = saved
        torch.cuda.synchronize()
        runs[impl] = (steps, ista_loop.launches - before)
        assert len(list((tmp_path / impl / "model.pth").glob("*/frame_*.png"))) == 12
    (got, k1), (want, k1_plain) = runs["cuda"], runs["plain"]
    assert len(got) == len(want) == len(k1_calls) > 12
    assert k1 == 2 * depth * len(got) and k1_plain == 0
    for k1_out, plain_out in k1_calls:
        assert k1_out.shape == (1, h // 2, w // 2, 2 * c) and k1_out.dtype == dtype
        torch.testing.assert_close(k1_out.float(), plain_out.float(), atol=tol, rtol=tol)
    for (g, g_st), (w_, w_st) in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (1, h, w, 1)
        torch.testing.assert_close(g, w_, atol=tol, rtol=tol)
        for a, b in zip((g_st.z, g_st.cell, *g_st.dg), (w_st.z, w_st.cell, *w_st.dg)):
            torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


def test_raw_mode_on_card_matches_voxel_mode(card):
    """Two packs on the card with the same explicit draws through raw mode
    (the plain loop records the events; K3 records none) and through voxel
    mode with K3: equal event counts, and the raw events binned in time and
    normalised equal K3's voxel grid within 1e-4."""
    from v2e2v_tpu_torch.models.emulator import (
        EmulatorConfig,
        GeneratorNoise,
        bin_raw_events,
        emulate_pack,
        emulate_pack_raw,
    )
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.voxel import event_preprocess

    b, n, h, w = 2, 6, 32, 48
    cfg = EmulatorConfig(pos_thres=0.6, neg_thres=0.6, sigma_thres=0.03, pl=1.5, ps=0.5,
                         cutoff_hz=200.0, ql=1.0, qs=0.0, refractory_period_s=0.001,
                         leak_rate_hz=0.1, shot_noise_rate_hz=100.0)
    g = torch.Generator().manual_seed(3)
    base = 30 + 190 * torch.rand(b, 1, h, w, generator=g)
    i = torch.arange(2 * n, dtype=torch.float32).reshape(1, -1, 1, 1)
    frames = (base * torch.exp(0.5 * torch.sin(0.7 * i + 6 * base / 220))).clamp(0, 255).to(card)
    ts = (0.004 * i.reshape(1, -1)).expand(b, -1).to(card)
    noises = [GeneratorNoise(torch.Generator(device=card).manual_seed(4), explicit_shot=True)
              for _ in range(2)]
    raw_state = vox_state = None
    for p in range(2):
        f, t = frames[:, p * n:(p + 1) * n], ts[:, p * n:(p + 1) * n]
        before = emulator_iters.launches
        events, n_raw, raw_state = emulate_pack_raw(cfg, raw_state, f, t, noises[0], device=card)
        assert emulator_iters.launches == before
        voxel, n_vox, vox_state = emulate_pack(cfg, vox_state, f, t, noises[1], device=card)
        assert emulator_iters.launches - before == n - 1
        assert n_raw == int(n_vox) == len(events) > 1000
        binned = bin_raw_events(events, b, h, w, cfg.num_bins, device=card)
        normed = event_preprocess(binned.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        torch.testing.assert_close(normed, voxel, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_cista_tc_on_card_matches_cpu(card, dtype, tol):
    """CISTA-TC (layers on cuDNN, no kernel of the port) three steps on the
    card against float32 on the CPU with the same weights and voxel grids;
    K1 and K2 are not launched."""
    from v2e2v_tpu_torch.models.cista import init_cista_tc

    cfg = CistaConfig(image_dim=(32, 48), base_channels=16, depth=3, model_mode="cista-tc")
    sd = init_cista_tc(torch.Generator().manual_seed(0), cfg, device="cpu")
    vox = torch.randn(3, 2, 32, 48, 5, generator=torch.Generator().manual_seed(1))
    want, want_state = cista_sequence(sd, cfg, vox)
    before = (ista_loop.launches, k2.cista_core.launches)
    got, got_state = cista_sequence({k: v.to(card, dtype) for k, v in sd.items()}, cfg,
                                    vox.to(card, dtype))
    torch.cuda.synchronize()
    assert (ista_loop.launches, k2.cista_core.launches) == before
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=tol)
    torch.testing.assert_close(got_state.z.float().cpu(), want_state.z, atol=tol, rtol=tol)


def test_v2e2v_cli_through_kernels_matches_plain(card, tmp_path, capsys):
    """The V2E2V CLI on two short sequences (data/synthetic.write_hfr_dataset)
    through K3 and K1 and through their plain versions, with the same
    explicit draws per sequence: K3 launches once per frame pair (N - 1 on a
    sequence's first pack, N - 2 on the next, whose reader returns N - 1 new
    frames) and K1 2 x depth times per pack, the printed averages are equal
    and every reconstruction is within 1e-4."""
    from v2e2v_tpu_torch.cli import test as cli
    from v2e2v_tpu_torch.data.synthetic import write_hfr_dataset
    from v2e2v_tpu_torch.models import v2e2v as v2e2v_mod
    from v2e2v_tpu_torch.models.emulator import GeneratorNoise
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.utils.configs import set_configs

    h, w, c, depth, n = 32, 48, 16, 3, 6
    write_hfr_dataset(tmp_path / "data", 0, 2, 16, h, w)
    cfg = CistaConfig(image_dim=(h, w), base_channels=c, depth=depth)
    torch.save({"epoch": 0, "v2e_params": None,
                "state_dict": init_cista_lstc(torch.Generator().manual_seed(0), cfg, "cpu")},
               tmp_path / "model.pth.tar")
    forward, runs = v2e2v_mod.v2e2v_forward, {}

    for impl in ("cuda", "plain"):
        parser = cli.argparse.ArgumentParser()
        set_configs(parser)
        cfgs = parser.parse_args([
            "--path_to_test_model", str(tmp_path / "model.pth.tar"), "--path_to_test_data",
            str(tmp_path / "data"), "--image_dim", str(h), str(w), "-c", str(c), "-d", str(depth),
            "--num_pack_frames", str(n), "--C", "0.4", "--cutoff_hz", "200", "--qs", "0",
            "--is_write_event", "-o", str(tmp_path / impl)])
        run = cli.V2E2V(cfgs, card, lambda i: GeneratorNoise(
            torch.Generator(device=card).manual_seed(10 + i), explicit_shot=True))
        if impl == "plain":
            run.cfg = v2e2v_mod.V2E2VConfig(
                dataclasses.replace(run.cfg.cista, ista_impl="plain"),
                dataclasses.replace(run.cfg.emulator, iters_impl="plain"))
        outs, launches = [], []

        def recorded(*a, outs=outs, launches=launches, **k):
            before = (emulator_iters.launches, ista_loop.launches)
            out, state = forward(*a, **k)
            launches.append((emulator_iters.launches - before[0],
                             ista_loop.launches - before[1]))
            outs.append(out)
            return out, state

        v2e2v_mod.v2e2v_forward = recorded
        try:
            run.run()
        finally:
            v2e2v_mod.v2e2v_forward = forward
        torch.cuda.synchronize()
        runs[impl] = (outs, launches, capsys.readouterr().out)
        assert len(list((tmp_path / impl / "model.pth").glob("*/events/events_*.png"))) == 4
    (got, k_got, out_got), (want, k_want, out_want) = runs["cuda"], runs["plain"]
    assert len(got) == len(want) == 4
    assert k_got == [(n - 1, 2 * depth), (n - 2, 2 * depth)] * 2 and k_want == [(0, 0)] * 4
    avg = [line for line in out_got.splitlines() if line.startswith("Avg number")]
    assert len(avg) == 2 and avg == [line for line in out_want.splitlines()
                                     if line.startswith("Avg number")]
    for a, b in zip(got, want):
        assert int(a.num_events) == int(b.num_events) > 0
        torch.testing.assert_close(a.reconstruction, b.reconstruction, atol=1e-4, rtol=1e-4)


def test_kernels_refuse_to_run_under_autograd(card):
    """K1 and K2 write through raw pointers and have no backward: under
    autograd, with an argument that requires grad, they raise on the card as
    on the CPU; under ``torch.no_grad`` they run."""
    args = list(_inputs(1, 8, 16, 8, card, torch.float32))
    args[2] = args[2].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match='ista_impl="plain", core_impl="layers"'):
        ista_loop(*args, depth=2)
    before = ista_loop.launches
    with torch.no_grad():
        ista_loop(*args, depth=2)
    assert ista_loop.launches - before == 4

    cfg = CistaConfig(image_dim=(16, 32), base_channels=8, depth=2)
    sd = init_cista_lstc(torch.Generator().manual_seed(0), cfg, device=card)
    taps = k2.core_taps(sd, torch.float32)
    taps["w_p"] = taps["w_p"].clone().requires_grad_(True)
    state = [torch.randn(1, 8, 16, ch, device=card) for ch in (8, 16, 16, 8, 8)]
    with pytest.raises(RuntimeError, match="cista_core"):
        k2.cista_core(taps, *state, depth=2)
    with torch.no_grad():
        k2.cista_core(taps, *state, depth=2)


def test_e2v_train_step_on_card_matches_cpu(card):
    """One E2V train step (32x48, C = 16, depth 3, T = 3, B = 2) on the card
    and on the CPU from the same weights and batch: the loss within 1e-4
    relative, each gradient within 1e-3 of its largest entry; K1 and K2 are
    not launched (the training config runs the plain ISTA loop)."""
    from v2e2v_tpu_torch.models.cista import tie_weights
    from v2e2v_tpu_torch.training import steps
    from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS

    cfg = CistaConfig(image_dim=(32, 48), base_channels=16, depth=3, ista_impl="plain")
    g = torch.Generator().manual_seed(3)
    seq, gt = torch.randn(3, 2, 32, 48, 5, generator=g), torch.rand(2, 32, 48, 1, generator=g)
    results = []
    for device in ("cpu", card):
        sd = tie_weights(init_cista_lstc(torch.Generator().manual_seed(0), cfg, device), cfg)
        step = steps.make_e2v_train_step(cfg, steps.make_adam(sd, cfg, 1e-4))
        before = (ista_loop.launches, k2.cista_core.launches)
        loss = step(sd, seq.to(device), gt.to(device))
        torch.cuda.synchronize()
        assert (ista_loop.launches, k2.cista_core.launches) == before
        results.append((float(loss), {k: sd[k].grad.cpu() for k in STEP_KEYS["cista-lstc"]}))
    (want, want_g), (got, got_g) = results
    assert abs(got - want) <= 1e-4 * abs(want)
    for k, w in want_g.items():
        assert float((got_g[k] - w).abs().max()) <= 1e-3 * float(w.abs().max()), k


@pytest.mark.parametrize("explicit_shot", [True, False], ids=["explicit", "internal"])
def test_v2e2v_train_step_through_k3_matches_plain(card, explicit_shot):
    """One V2E2V train step with the emulator's loop as K3 (once per frame
    pair and pack) against ``iters_impl="plain"`` on the same card generator
    seed: equal event counts, the loss within 1e-5; K1 is not launched."""
    from v2e2v_tpu_torch.models.cista import tie_weights
    from v2e2v_tpu_torch.models.emulator import EmulatorConfig, GeneratorNoise
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.training import steps

    h, w, n, b, t = 32, 48, 6, 2, 3
    emu = EmulatorConfig(pos_thres=0.6, neg_thres=0.6, sigma_thres=0.03, pl=1.5, ps=0.5,
                         cutoff_hz=200.0, ql=1.0, qs=0.0, refractory_period_s=0.001,
                         leak_rate_hz=0.1, shot_noise_rate_hz=100.0)
    cista = CistaConfig(image_dim=(h, w), base_channels=16, depth=2, ista_impl="plain")
    g = torch.Generator().manual_seed(1)
    base = 30 + 190 * torch.rand(b, 1, h, w, generator=g)
    rate = torch.rand(b, 1, h, w, generator=g) - 0.5
    i = torch.arange(t * (n - 1) + 1, dtype=torch.float32).reshape(1, -1, 1, 1)
    video = (base * torch.exp(rate * torch.sin(0.7 * i))).clamp(0, 255)
    frames = torch.stack([video[:, p * (n - 1):p * (n - 1) + n] for p in range(t)]).to(card)
    ts = torch.stack([(0.004 * i.reshape(1, -1)[:, p * (n - 1):p * (n - 1) + n]).expand(b, -1)
                      for p in range(t)]).to(card)
    gt = torch.rand(b, h, w, 1, generator=g).to(card)
    results = []
    for impl in ("cuda", "plain"):
        cfg = V2E2VConfig(cista, dataclasses.replace(emu, iters_impl=impl))
        sd = tie_weights(init_cista_lstc(torch.Generator().manual_seed(0), cista, card), cista)
        step = steps.make_v2e2v_train_step(cfg, steps.make_adam(sd, cista, 1e-4))
        noise = GeneratorNoise(torch.Generator(device=card).manual_seed(2), explicit_shot)
        before = (emulator_iters.launches, ista_loop.launches)
        loss, stats = step(sd, frames, ts, gt, noise)
        torch.cuda.synchronize()
        launches = (emulator_iters.launches - before[0], ista_loop.launches - before[1])
        results.append((float(loss), int(stats["num_events"]), launches))
    (loss_k, ev_k, (k3_n, k1_n)), (loss_p, ev_p, plain_n) = results
    assert (k3_n, k1_n) == (t * (n - 1), 0) and plain_n == (0, 0)
    assert ev_k == ev_p > 0
    assert abs(loss_k - loss_p) <= 1e-5


@pytest.mark.parametrize("mode,core_impl", [("cista-lstc", "layers"), ("cista-lstc", "cuda"),
                                            ("cista-tc", "layers")])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_fused_fullres_on_card_matches_cpu(card, mode, core_impl, dtype, tol):
    """``fullres_impl="fused"`` (ops/fused.py on cuDNN) three steps on the card
    against float32 on the CPU (the plain versions), with K1 or K2 in the
    LSTC core as ``core_impl`` says, 2 x depth or 7 + 2 x depth launches per
    step; the card's fused kernels are channels_last OIHW in memory."""
    from v2e2v_tpu_torch.models.cista import init_cista_tc, with_derived

    cfg = CistaConfig(image_dim=(32, 48), base_channels=16, depth=3, model_mode=mode,
                      core_impl=core_impl, fullres_impl="fused")
    init = init_cista_lstc if mode == "cista-lstc" else init_cista_tc
    sd = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    vox = torch.randn(3, 2, 32, 48, 5, generator=torch.Generator().manual_seed(1))
    want, want_state = cista_sequence(sd, cfg, vox)
    sd_card = {k: v.to(card, dtype) for k, v in sd.items()}
    kernels = with_derived(sd_card, cfg, dtype)["_fullres_fused"]
    assert kernels["upsamp"][0].permute(3, 2, 0, 1).is_contiguous(
        memory_format=torch.channels_last)
    before = (ista_loop.launches, k2.cista_core.launches)
    got, got_state = cista_sequence(sd_card, cfg, vox.to(card, dtype))
    torch.cuda.synchronize()
    launches = (ista_loop.launches - before[0], k2.cista_core.launches - before[1])
    if mode == "cista-tc":
        assert launches == (0, 0)
    elif core_impl == "cuda":
        assert launches == (0, 3 * k2.launches_per_call(3))
    else:
        assert launches == (3 * 2 * 3, 0)
    torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=tol)
    torch.testing.assert_close(got_state.z.float().cpu(), want_state.z, atol=tol, rtol=tol)


def test_parity_io_and_fused_lstc_on_card_match_full_layout(card):
    """``io_layout="parity"`` from the parity voxel producer
    (``input_packed``) and ``lstc_impl="fused"`` on the card against the
    full layout with the three-conv ConvLSTC, float32."""
    from v2e2v_tpu_torch.ops.voxel import events_to_voxel_grid

    cfg = CistaConfig(image_dim=(32, 48), base_channels=16, depth=3, fullres_impl="fused")
    sd = init_cista_lstc(torch.Generator().manual_seed(0), cfg, device=card)
    g = torch.Generator().manual_seed(2)
    n = 3000
    grids = []
    for _ in range(6):  # 3 steps x B = 2
        t = torch.sort(torch.rand(n, generator=g))[0].double()
        x, y = torch.randint(0, 48, (n,), generator=g), torch.randint(0, 32, (n,), generator=g)
        p = torch.randint(0, 2, (n,), generator=g)
        ev = [a.to(card) for a in (t, x, y, p)]
        grids.append((events_to_voxel_grid(*ev, n, num_bins=5, width=48, height=32),
                      events_to_voxel_grid(*ev, n, num_bins=5, width=48, height=32,
                                           layout="parity")))
    full = torch.stack([a.permute(1, 2, 0) for a, _ in grids]).reshape(3, 2, 32, 48, 5)
    packed = torch.stack([b for _, b in grids]).reshape(3, 2, 16, 24, 20)
    want, want_state = cista_sequence(sd, cfg, full)
    for c, seq, kw in ((dataclasses.replace(cfg, io_layout="parity"), packed,
                        {"input_packed": True}),
                       (dataclasses.replace(cfg, lstc_impl="fused"), full, {})):
        got, got_state = cista_sequence(sd, c, seq, **kw)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got_state.cell, want_state.cell, atol=1e-4, rtol=1e-4)


def test_fused_e2v_train_step_on_card_matches_cpu(card):
    """The E2V train step on the fused full-resolution path on the card
    against the CPU (as ``test_e2v_train_step_on_card_matches_cpu``)."""
    from v2e2v_tpu_torch.models.cista import tie_weights
    from v2e2v_tpu_torch.training import steps
    from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS

    cfg = CistaConfig(image_dim=(32, 48), base_channels=16, depth=3, ista_impl="plain",
                      fullres_impl="fused")
    g = torch.Generator().manual_seed(3)
    seq, gt = torch.randn(3, 2, 32, 48, 5, generator=g), torch.rand(2, 32, 48, 1, generator=g)
    results = []
    for device in ("cpu", card):
        sd = tie_weights(init_cista_lstc(torch.Generator().manual_seed(0), cfg, device), cfg)
        step = steps.make_e2v_train_step(cfg, steps.make_adam(sd, cfg, 1e-4))
        loss = step(sd, seq.to(device), gt.to(device))
        results.append((float(loss), {k: sd[k].grad.cpu() for k in STEP_KEYS["cista-lstc"]}))
    (want, want_g), (got, got_g) = results
    assert abs(got - want) <= 1e-4 * abs(want)
    for k, w in want_g.items():
        assert float((got_g[k] - w).abs().max()) <= 1e-3 * float(w.abs().max()), k


# K4's conv sites at C = 64 (cin_a, cin_b, cout): gates, P0, out_gates, D, P,
# dg, lstm; then a ragged tile, a half chunk of 16 channels and a partial
# block of output channels, and the 2x2 minimum
K4_SITES = [(64, 128, 256), (64, 0, 128), (128, 128, 128), (128, 0, 64), (64, 0, 128),
            (128, 0, 64), (64, 64, 256)]
K4_SMALL = [(1, 17, 23, 16, 32, 72), (3, 2, 2, 48, 0, 8)]


def _k4_inputs(device, b, h, w, cin_a, cin_b, cout, full, seed=0):
    """int8 inputs in [-15, 15] with unit scales and no bias (the integer
    core: ``|acc| < 2^24``), or full-range codes with real scales and bias."""
    g = torch.Generator().manual_seed(seed)
    lim = 128 if full else 16
    xa = torch.randint(-lim + 1, lim, (b, h, w, cin_a), generator=g, dtype=torch.int8)
    xb = torch.randint(-lim + 1, lim, (b, h, w, cin_b), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin_a + cin_b, 3, 3), generator=g, dtype=torch.int8)
    if full:
        s_x, s_w = torch.tensor(0.0123), torch.rand(cout, generator=g) * 1e-3
        bias = torch.randn(cout, generator=g)
    else:
        s_x, s_w, bias = torch.tensor(1.0), torch.ones(cout), None
    to = (lambda t: None if t is None else t.to(device))
    return (to(xa), to(s_x), to(wq), to(s_w), to(bias), to(xb) if cin_b else None)


@pytest.mark.parametrize("dims", [(1, 90, 120, *s) for s in K4_SITES] + K4_SMALL, ids=str)
@pytest.mark.parametrize("full", [False, True], ids=["integer", "full-range"])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_qconv_kernel_matches_plain(card, dims, full, out):
    """K4 against its plain version: the integer core equal, and with real
    scales equal (the plain version's float64 single rounding of the fused
    multiply-add; a double rounding could leave one output an ulp off, never
    seen)."""
    from v2e2v_tpu_torch.ops.cuda.qconv import qconv3x3, qconv3x3_plain

    args = _k4_inputs(card, *dims, full)
    before = dict(qconv3x3.launches_by_dtype)
    got = qconv3x3(*args, out_dtype=out)
    want = qconv3x3_plain(*args, out_dtype=out)
    torch.cuda.synchronize()
    assert got.dtype == out and got.shape == want.shape
    name = "float32" if out == torch.float32 else "bfloat16"
    assert qconv3x3.launches_by_dtype[name] == before[name] + 1
    if full:
        bits = torch.int32 if out == torch.float32 else torch.int16
        ulps = (got.view(bits).int() - want.view(bits).int()).abs()
        assert int(ulps.max()) <= 1 and int((ulps > 0).sum()) <= 1e-5 * ulps.numel()
    else:
        assert torch.equal(got, want)


def _k4_float_inputs(device, b, h, w, cin_a, cin_b, cout, dtype, seed=0):
    """Float inputs for K4 to quantize with the static s_x = 2^-4: values on
    its .5 ties and past +-127 (saturating), a few extremes, weights, scales
    and a bias."""
    g = torch.Generator().manual_seed(seed)
    s_x = torch.tensor(0.0625)
    x = (torch.randint(-300, 301, (b, h, w, cin_a + cin_b), generator=g).float() / 2 * s_x)
    # values past 2^64, infinities, subnormals and zeros take the kernel's
    # exact division's other path
    x.view(-1)[:10] = torch.tensor([1e30, -3e38, float("inf"), float("-inf"), 1e-40, -1e-30,
                                    0.0, -0.0, 2e19, -7e-20])
    x = x.to(dtype)
    wq = torch.randint(-127, 128, (cout, cin_a + cin_b, 3, 3), generator=g, dtype=torch.int8)
    s_w, bias = torch.rand(cout, generator=g) * 1e-3, torch.randn(cout, generator=g)
    xa, xb = x[..., :cin_a].contiguous(), x[..., cin_a:].contiguous() if cin_b else None
    to = (lambda t: None if t is None else t.to(device))
    return (to(xa), to(s_x), to(wq), to(s_w), to(bias), to(xb))


@pytest.mark.parametrize("dims", [(1, 90, 120, *s) for s in K4_SITES] + K4_SMALL, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["in-f32", "in-bf16"])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_qconv_kernel_float_input_matches_plain(card, dims, dtype, out):
    """K4 quantizing a float input while it stages it, against its plain
    version (``quantize_with``, then the integer conv): outputs as in
    ``test_qconv_kernel_matches_plain``; and the codes themselves, read back
    through identity centre-tap weights (unit scales, out = code * 2^-4
    exactly), equal ``quantize_with``'s, ties to even and +-127 included."""
    from v2e2v_tpu_torch.ops.cuda.qconv import qconv3x3, qconv3x3_plain, quantize_with

    args = _k4_float_inputs(card, *dims, dtype)
    before = dict(qconv3x3.launches_by_input)
    got = qconv3x3(*args, out_dtype=out)
    want = qconv3x3_plain(*args, out_dtype=out)
    torch.cuda.synchronize()
    name = "float32" if dtype == torch.float32 else "bfloat16"
    assert qconv3x3.launches_by_input[name] == before[name] + 1
    assert got.dtype == out and got.shape == want.shape
    bits = torch.int32 if out == torch.float32 else torch.int16
    ulps = (got.view(bits).int() - want.view(bits).int()).abs()
    assert int(ulps.max()) <= 1 and int((ulps > 0).sum()) <= 1e-5 * ulps.numel()
    if out == torch.float32:
        xa, s_x, wq, _, _, xb = args
        cin, cout = wq.shape[1], wq.shape[0]
        eye = torch.zeros_like(wq)
        n = min(cin, cout)
        eye[torch.arange(n), torch.arange(n), 1, 1] = 1
        ones = torch.ones(cout, device=card)
        codes = torch.cat([quantize_with(p, s_x) for p in (xa, xb) if p is not None], -1)
        back = qconv3x3(xa, s_x, eye, ones, None, xb) / s_x
        assert torch.equal(back[..., :n], codes[..., :n].float())
        assert int(codes.abs().max()) == 127


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shapes", [[(8, 90, 120, 64), (8, 90, 120, 128)], [(1, 90, 120, 128)],
                                    [(3, 5, 7, 3)], [(2, 3, 1, 5), (2, 3, 1, 7)]], ids=str)
def test_qscale_kernel_matches_plain(card, dtype, shapes):
    """The scale kernel against its plain version, bit for bit: a site's
    parts at B = 8 and 1, element counts that leave a tail of fewer than 16
    bytes, twice in a row (the ticket resets), a zero tensor (scale 1) and a
    maximum where dividing by 127 and multiplying by f32(1 / 127) differ."""
    from v2e2v_tpu_torch.ops.cuda.qscale import act_scale, act_scale_plain

    g = torch.Generator().manual_seed(len(shapes))
    parts = [(torch.randn(s, generator=g) * (1 + 3 * i)).to(dtype).to(card)
             for i, s in enumerate(shapes)]
    before = act_scale.launches
    for _ in range(2):
        got, want = act_scale(parts), act_scale_plain(parts)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.view(torch.int32) == want.view(torch.int32)
    assert act_scale.launches == before + 2
    assert float(act_scale([torch.zeros_like(p) for p in parts])) == 1.0
    # max |x| = 0.8125: its product with f32(1 / 127) and a true division
    # by 127 round apart
    x = torch.full((3, 5, 7, 16), 0.25, dtype=dtype, device=card)
    x[1, 2, 3, 4] = -0.8125
    assert act_scale([x]).view(torch.int32) == act_scale_plain([x]).view(torch.int32)


def test_qconv_kernel_refuses_what_it_cannot_run(card):
    from v2e2v_tpu_torch.ops.cuda.qconv import qconv3x3

    xa, s_x, wq, s_w, bias, _ = _k4_inputs(card, 1, 8, 16, 32, 0, 16, True)
    for kw, match in (({"padding": 0}, "padding=1"), ({"stride": 2}, "stride=1"),
                      ({"pad_mode": "zeros"}, "reflect")):
        with pytest.raises(ValueError, match=match):
            qconv3x3(xa, s_x, wq, s_w, bias, **kw)
    x8, w8 = xa[..., :8].contiguous(), wq[:, :8].contiguous()
    with pytest.raises(ValueError, match="% 16"):
        qconv3x3(x8, s_x, w8, s_w, bias)
    with pytest.raises(ValueError, match="cout % 8"):
        qconv3x3(xa, s_x, wq[:12].contiguous(), s_w[:12], bias[:12])
    with pytest.raises(ValueError, match="contiguous"):
        qconv3x3(xa.transpose(1, 2), s_x, wq, s_w, bias)
    flat = torch.zeros(xa.numel() + 8, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        qconv3x3(flat[8:].view(xa.shape), s_x, wq, s_w, bias)
    with pytest.raises(RuntimeError, match="without a backward"):
        qconv3x3(xa, s_x.clone().requires_grad_(True), wq, s_w, bias)
    with torch.no_grad():
        qconv3x3(xa, s_x.clone().requires_grad_(True), wq, s_w, bias)
    # a float input: the same refusals, never a copy of a strided input
    from v2e2v_tpu_torch.ops.cuda.qscale import act_scale

    xf = xa.float()
    with pytest.raises(ValueError, match="contiguous"):
        qconv3x3(xf.transpose(1, 2), s_x, wq, s_w, bias)
    with pytest.raises(ValueError, match="contiguous"):
        act_scale([xf.transpose(1, 2)])
    with pytest.raises(TypeError, match="one dtype"):
        qconv3x3(xf[..., :16].contiguous(), s_x, wq, s_w, bias, xb=xa[..., 16:].contiguous())
    flat = torch.zeros(xf.numel() + 1, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        qconv3x3(flat[1:].view(xf.shape), s_x, wq, s_w, bias)


@pytest.mark.parametrize("mode", ["cista-lstc", "cista-tc"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_int8_pool_through_k4_matches_plain(card, mode, dtype, tol):
    """A 3-step int8 pool (32x48, C = 16, depth 2, capacity 2) through K4
    against the same pool through K4's plain version (``qconv_impl="plain"``):
    reconstructions and all four states; K4 launched 3 + 2 depth + 2 (LSTC)
    or 1 + 2 depth + 2 (TC) times per step, and the scale kernel as many
    times; then ``calibrate`` and 3 more steps with the static scales (no
    scale kernel)."""
    from v2e2v_tpu_torch.models.cista import init_cista_tc
    from v2e2v_tpu_torch.ops.cuda.qconv import qconv3x3
    from v2e2v_tpu_torch.ops.cuda.qscale import act_scale
    from v2e2v_tpu_torch.serving import StreamPool

    cfg = CistaConfig(image_dim=(32, 48), base_channels=16, depth=2, model_mode=mode,
                      quant="int8")
    init = init_cista_lstc if mode == "cista-lstc" else init_cista_tc
    sd = init(torch.Generator().manual_seed(0), cfg, device=card)
    g = torch.Generator().manual_seed(1)
    vox = torch.randn(6, 2, 32, 48, 5, generator=g).to(card)
    pools = [StreamPool(dataclasses.replace(cfg, qconv_impl=impl), sd, 2, dtype, device=card)
             for impl in ("cuda", "plain")]
    ids = [[p.attach() for _ in range(2)] for p in pools]
    per_step = (3 if mode == "cista-lstc" else 1) + 2 * 2 + 2
    for t in range(6):
        if t == 3:
            assert [p.calibrate(vox[:3]) for p in pools] == [True, True]
        before, scales = qconv3x3.launches, act_scale.launches
        outs = [p.step({s: vox[t, i] for i, s in enumerate(sids)}, fetch=False)
                for p, sids in zip(pools, ids)]
        assert qconv3x3.launches - before == per_step
        # one scale kernel per site with dynamic scales, none once calibrated
        assert act_scale.launches - scales == (per_step if t < 3 else 0)
        for a, b in zip(ids[0], ids[1]):
            torch.testing.assert_close(outs[0][a].float(), outs[1][b].float(), atol=tol, rtol=tol)
        for x, y in zip((pools[0]._states.cell, pools[0]._states.z, *pools[0]._states.dg),
                        (pools[1]._states.cell, pools[1]._states.z, *pools[1]._states.dg)):
            torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=tol)


def test_upsampler_on_card_matches_cpu(card, tmp_path):
    """The Super-SloMo upsampler (no kernel of the port: cuDNN's float32
    convs, TF32 off by the upsampler itself) on the card against the CPU:
    four frames at 32x40, random weights seeded 0 with the flow net's output
    conv scaled by 60, so that each pair gives 4 frames (magnitudes 3.3-3.6,
    0.3 or more from an integer on the CPU): equal counts and stamps, frames
    within one code."""
    import numpy as np

    from v2e2v_tpu_torch.models import superslomo as slomo

    gen = torch.Generator().manual_seed(0)
    flow_net, intrp_net = slomo.UNet(6, 4, gen), slomo.UNet(20, 5, gen)
    with torch.no_grad():
        flow_net.conv3.weight.mul_(60.0)
        flow_net.conv3.bias.mul_(60.0)
    ckpt = str(tmp_path / "SuperSloMo.ckpt")
    torch.save({"state_dictFC": flow_net.state_dict(), "state_dictAT": intrp_net.state_dict()},
               ckpt)
    rng = np.random.default_rng(3)
    frames = [rng.uniform(0, 255, (32, 40)).astype(np.uint8) for _ in range(4)]
    stamps = [0.0, 0.1, 0.25, 0.3]
    torch.backends.cudnn.allow_tf32 = True  # the upsampler turns it off for its own calls
    got_frames, got_ts = slomo.Upsampler([32, 40], ckpt_path=ckpt).upsampling(frames, stamps)
    want_frames, want_ts = slomo.Upsampler([32, 40], ckpt_path=ckpt,
                                           device="cpu").upsampling(frames, stamps)
    assert torch.backends.cudnn.allow_tf32
    np.testing.assert_array_equal(got_ts, want_ts)
    assert len(got_ts) == 3 * 4 + 1
    assert np.abs(got_frames.astype(int) - want_frames.astype(int)).max() <= 1
