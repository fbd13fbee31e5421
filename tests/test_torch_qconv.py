"""The port's int8 primitives (``v2e2v_tpu_torch/ops/qconv.py``), kernel
K4's plain version, tap layout and a model of its blocks (``ops/cuda/qconv.py``,
``ops/cuda/conv_tc.s8_taps``, ``csrc/qconv3x3.cu``) and the scale kernel's
plain version (``ops/cuda/qscale.py``) against the JAX package's
``ops/qconv.py``.

The JAX side runs jitted, as every JAX step runs it: compiled XLA divides by
the constant 127 as a product with its float32 reciprocal, which the port
copies (``numerics.div_const``). Quantization is bit-equal. The integer core
is exact on both sides. The dequant ``acc * (s_x * s_w) + bias`` is one
fused multiply-add in the port (as XLA compiles it at its default level);
under this suite's ``--xla_backend_optimization_level=0`` XLA multiplies and
adds separately: each side is then exactly its own rounding of the same
exact sum, and the two differ only where the product's rounding moves the
result. The cells (a sigmoid and tanh of those outputs) are held to 2e-6.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.ops import qconv as jq
from v2e2v_tpu_torch.ops import qconv as tq
from v2e2v_tpu_torch.ops.cuda import conv_tc
from v2e2v_tpu_torch.ops.cuda.qconv import qconv3x3, qconv3x3_plain

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "v2e2v_tpu_torch" / "csrc" / "qconv3x3.cu").read_text()
# the kernel's own integer constants (``constexpr int A = 1, B = 2;``)
K = {name: int(v) for decl in re.findall(r"constexpr int ([^;]*);", SOURCE)
     for name, v in re.findall(r"(\w+) = (\d+)(?:,|$)", decl)}


def _weights(cin, cout, seed, zero_channel=None):
    """OIHW float32 weights drawn as torch's conv init draws them, and a bias."""
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(9 * cin)
    w = rng.uniform(-bound, bound, (cout, cin, 3, 3)).astype(np.float32)
    if zero_channel is not None:
        w[zero_channel] = 0
    return w, rng.uniform(-bound, bound, cout).astype(np.float32)


def _jqp(w, b):
    """JAX's quantized params of OIHW ``w`` (HWIO on its side), jitted."""
    return jax.jit(jq.quantize_conv_params)(
        {"weight": jnp.asarray(w.transpose(2, 3, 1, 0)), "bias": jnp.asarray(b)})


def _tqp(jqp):
    """JAX's quantized params carried to the port's layout (OIHW)."""
    out = {"w_q": torch.from_numpy(np.asarray(jqp["w_q"]).transpose(3, 2, 0, 1).copy()),
           "s_w": torch.from_numpy(np.array(jqp["s_w"]))}
    if "bias" in jqp:
        out["bias"] = torch.from_numpy(np.array(jqp["bias"]))
    return out


def _dequant(acc, s, bias):
    """``acc * s + bias`` from the exact int32 sums ``acc``, float32 ``s``
    and ``bias``, rounded as the fused multiply-add rounds it (float64, one
    rounding to float32) and as a separate multiply and add round it."""
    a32 = acc.astype(np.float32)
    fused = (a32.astype(np.float64) * s.astype(np.float64) + bias).astype(np.float32)
    separate = (a32 * s).astype(np.float32) + bias
    return fused, separate

@pytest.mark.parametrize("cin,cout,zero", [(128, 64, None), (64, 128, 5), (192, 256, 0),
                                           (16, 8, 7)])
def test_quantize_conv_params_bit_equal_to_jax(cin, cout, zero):
    """``w_q``, ``s_w`` and ``bias`` equal JAX's, a zero channel's scale 1
    and codes 0 included."""
    w, b = _weights(cin, cout, cin + cout, zero)
    want = _jqp(w, b)
    got = tq.quantize_conv_params({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    assert got["w_q"].dtype == torch.int8 and got["s_w"].dtype == torch.float32
    np.testing.assert_array_equal(got["w_q"].numpy(),
                                  np.asarray(want["w_q"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["s_w"].numpy(), np.asarray(want["s_w"]))
    np.testing.assert_array_equal(got["bias"].numpy(), np.asarray(want["bias"]))
    if zero is not None:
        assert float(got["s_w"][zero]) == 1.0 and not got["w_q"][zero].any()
    # w / s_w is a true division on both sides: pinned against numpy's
    s_w = got["s_w"].numpy()
    codes = np.clip(np.round(w / s_w[:, None, None, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got["w_q"].numpy(), codes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero", [False, True], ids=["normal", "all-zero"])
def test_quantize_activation_and_with_bit_equal_to_jax(dtype, zero):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 9, 12, 48)) * 3).astype(np.float32) * (0 if zero else 1)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = jax.jit(jq.quantize_activation)(jx)
    got_q, got_s = tq.quantize_activation(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32 and got_s.dim() == 0
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert float(got_s) == float(want_s)
    if zero:
        assert float(got_s) == 1.0
    # a static scale below the range: saturation at +-127, ties to even
    s = np.float32(0.0173)
    want = jax.jit(jq.quantize_with)(jx, jnp.float32(s))
    got = tq.quantize_with(tx, torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0])
    assert tq.quantize_with(ties, torch.tensor(1.0)).tolist() == [0, 2, 2, 0, -2, 127, -127]


def test_dynamic_scale_of_a_concat_is_the_larger_part():
    """A concat's parts share one scale, the max over both: the port never
    builds the concat, and its codes equal JAX's codes of the concat."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 6, 7, 16)).astype(np.float32)
    b = 4 * rng.standard_normal((2, 6, 7, 32)).astype(np.float32)
    want_q, want_s = jax.jit(jq.quantize_activation)(jnp.concatenate([a, b], -1))
    s = tq._dynamic_scale((torch.from_numpy(a), torch.from_numpy(b)))
    assert float(s) == float(want_s)
    got = torch.cat([tq.quantize_with(torch.from_numpy(p), s) for p in (a, b)], -1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_q))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 128), (192, 256)])
def test_qconv2d_pre_on_jax_codes(cin, cout, out):
    """On JAX's own ``x_q``: the integer core is equal under unit scales (no
    bias, ``|acc| < 2^24``), and the dequantized outputs are each side's own
    rounding of it (JAX here multiplies and adds separately, the port
    fuses)."""
    w, b = _weights(cin, cout, 7)
    jqp = _jqp(w, b)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 10, 13, cin)).astype(np.float32)
    x_q, s_x = jax.jit(jq.quantize_activation)(jnp.asarray(x))
    odt = getattr(jnp, out)
    pre = jax.jit(jq.qconv2d_pre, static_argnames=("out_dtype",))
    tx_q = torch.from_numpy(np.array(x_q))

    small = np.clip(np.asarray(x_q), -15, 15)
    unit = {"w_q": jqp["w_q"], "s_w": jnp.ones(cout, jnp.float32)}
    want = pre(jnp.asarray(small), jnp.float32(1), unit, out_dtype=jnp.float32)
    got = tq.qconv2d_pre(torch.from_numpy(small), torch.tensor(1.0),
                         {"w_q": _tqp(jqp)["w_q"], "s_w": torch.ones(cout)},
                         out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # the exact integer sums of the full-range codes (|acc| < 2^24 here too)
    acc = np.asarray(pre(x_q, jnp.float32(1), unit, out_dtype=jnp.float32)).astype(np.int64)
    want = pre(x_q, s_x, jqp, out_dtype=odt)
    got = tq.qconv2d_pre(tx_q, torch.tensor(np.float32(s_x)), _tqp(jqp),
                         out_dtype=getattr(torch, out))
    fused, separate = _dequant(acc, np.float32(s_x) * np.asarray(jqp["s_w"]), b)
    tdt = getattr(torch, out)
    fused, separate = (torch.from_numpy(v).to(tdt) for v in (fused, separate))
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(tdt)
    # each side is its own rounding of the same exact sum: the port's the
    # fused one, JAX's here the separate one; they differ only where the
    # product's own rounding moves the result (a third of the outputs in
    # float32, near a cancellation of product and bias by many ulps)
    assert torch.equal(got, fused) and torch.equal(want, separate)
    assert torch.equal(torch.eq(got, want), torch.eq(fused, separate))
    assert int(torch.eq(got, want).sum()) > got.numel() // 2


def test_plain_version_exact_against_integer_numpy():
    """Full-range codes, two inputs (a concat's parts), ragged sizes: the
    plain version's sum equals numpy's int64 sum, its dequant the float64
    single rounding."""
    rng = np.random.default_rng(6)
    xa = rng.integers(-127, 128, (2, 7, 9, 16), dtype=np.int8)
    xb = rng.integers(-127, 128, (2, 7, 9, 32), dtype=np.int8)
    w = rng.integers(-127, 128, (24, 48, 3, 3), dtype=np.int8)
    xp = np.pad(np.concatenate([xa, xb], -1).astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)),
                mode="reflect")
    acc = sum(np.einsum("bhwc,oc->bhwo", xp[:, dy:dy + 7, dx:dx + 9], w[:, :, dy, dx].astype(
        np.int64)) for dy in range(3) for dx in range(3))
    s_x, s_w = torch.tensor(np.float32(0.0213)), torch.from_numpy(
        rng.uniform(1e-4, 1e-2, 24).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    got = qconv3x3_plain(torch.from_numpy(xa), s_x, torch.from_numpy(w), s_w, bias,
                         torch.from_numpy(xb))
    s = (s_x * s_w).numpy().astype(np.float64)
    want = (acc.astype(np.float32).astype(np.float64) * s + bias.numpy()).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    unit = qconv3x3_plain(torch.from_numpy(xa), torch.tensor(1.0), torch.from_numpy(w),
                          torch.ones(24), None, torch.from_numpy(xb))
    np.testing.assert_array_equal(unit.numpy(), acc.astype(np.float32))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        qconv3x3(torch.from_numpy(xa), s_x, torch.from_numpy(w), s_w, bias,
                 torch.from_numpy(xb)).numpy(), want)


@pytest.mark.parametrize("padding,stride,mode", [(0, 1, "reflect"), (1, 2, "reflect"),
                                                 (1, 1, "zeros")])
def test_plain_qconv2d_other_padding_and_stride_matches_jax(padding, stride, mode):
    """The plain version takes the other paddings, strides and the zero pad
    mode as JAX's ``qconv2d`` does (K4 refuses them on the card)."""
    w, b = _weights(16, 8, 9)
    jqp = _jqp(w, b)
    x = np.random.default_rng(7).standard_normal((1, 9, 11, 16)).astype(np.float32)
    kw = dict(padding=padding, stride=stride, pad_mode=mode)
    want = jax.jit(jq.qconv2d, static_argnames=tuple(kw))(jnp.asarray(x), jqp, **kw)
    got = tq.qconv2d(torch.from_numpy(x), _tqp(jqp), **kw)
    assert got.shape == want.shape
    # each the rounding of the same exact sum, as in test_qconv2d_pre_on_jax_codes
    x_q, s_x = tq.quantize_activation(torch.from_numpy(x))
    acc = tq.qconv2d_pre(x_q, torch.tensor(1.0), {"w_q": _tqp(jqp)["w_q"], "s_w": torch.ones(8)},
                         out_dtype=torch.float32, **kw)
    fused, separate = _dequant(acc.numpy().astype(np.int64),
                               np.float32(s_x) * np.asarray(jqp["s_w"]), b)
    np.testing.assert_array_equal(got.numpy(), fused)
    np.testing.assert_array_equal(np.asarray(want), separate)


def _cell_inputs(c, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 8, 10, k)).astype(np.float32) for k in (c, 2 * c, 2 * c)]


def test_qconv_lstc_step_matches_jax():
    c = 16
    jqp = {k: _jqp(*_weights(i, o, s)) for k, i, o, s in (
        ("gates", 3 * c, 4 * c, 1), ("P0", c, 2 * c, 2), ("out_gates", 4 * c, 2 * c, 3))}
    x, z, cell = _cell_inputs(c, 8)
    want = jax.jit(jq.qconv_lstc_step)(jqp, jnp.asarray(x), jnp.asarray(z), jnp.asarray(cell))
    got = tq.qconv_lstc_step({k: _tqp(v) for k, v in jqp.items()}, torch.from_numpy(x),
                             torch.from_numpy(z), torch.from_numpy(cell))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-6)


def test_qconv_lstm_step_matches_jax():
    c = 16
    jqp = {"Gates": _jqp(*_weights(2 * c, 4 * c, 4))}
    x, h, cell = (a[..., :c] for a in _cell_inputs(c, 9))
    want = jax.jit(jq.qconv_lstm_step)(jqp, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(cell)))
    got = tq.qconv_lstm_step({"Gates": _tqp(jqp["Gates"])}, torch.from_numpy(x),
                             (torch.from_numpy(h), torch.from_numpy(cell)))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-6)


# K4's staging and descriptor strides as the source states them (checked
# against it below), in bytes
KCH = K["KCH"]
IN_H, IN_W = K["TILE_H"] + 2, K["TILE_W"] + 2
PIXELS = IN_H * IN_W
ITEMS = KCH // 16 * PIXELS
A_SBO, A_LBO = IN_W * 16, PIXELS * 16


def _b_lbo(nb):
    return nb * 16


B_SBO = 128


def test_k4_source_states_the_modelled_layout():
    """The constants and descriptor strides the models below restate."""
    assert (K["TILE_H"], K["TILE_W"], K["THREADS"], KCH, K["PER_THREAD"]) == (
        16, 8, 256, conv_tc.S8_KCH, 2)
    for decl in ("IN_H = TILE_H + 2, IN_W = TILE_W + 2", "ROWS = KCH / 16",
                 "PIXELS = IN_H * IN_W", "ITEMS = ROWS * PIXELS", "A_SBO = IN_W * 16",
                 "A_LBO = PIXELS * 16", "B_LBO = NB * 16, B_SBO = 128",
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8",
                 "for (int q = 0; q < KCH / 32; ++q)",
                 "return cout > 64 ? 128 : 64"):
        assert decl in SOURCE, decl
    assert [conv_tc.n_block(c) for c in (8, 64, 72, 128, 256)] == [64, 64, 128, 128, 128]


def _b_operand(slot, nb, q):
    """The ``[32, nb]`` B operand of k-step ``q`` read from one tap slice
    (flat bytes) through the K-major no-swizzle descriptor: element (k, n) in
    core matrix (k // 16, n // 8), row n % 8, byte k % 16."""
    k = torch.arange(32)[:, None]
    n = torch.arange(nb)[None, :]
    return slot[(2 * q + k // 16) * _b_lbo(nb) + (n // 8) * B_SBO + 16 * (n % 8) + k % 16]


@pytest.mark.parametrize("cin_a,cin_b,cout", [(64, 128, 256), (64, 0, 128), (128, 128, 128),
                                              (128, 0, 64), (64, 64, 256), (16, 32, 72),
                                              (48, 0, 8)])
def test_s8_taps_hold_every_b_operand(cin_a, cin_b, cout):
    """K4's taps, read back through the K-major descriptor of each tap's two
    k32 steps, give back every weight once, zeros past cin and cout, in the
    source's chunk and block sizes."""
    rng = np.random.default_rng(cin_a + cout)
    w = torch.from_numpy(rng.integers(-127, 128, (cout, cin_a + cin_b, 3, 3), dtype=np.int8))
    laid = conv_tc.s8_taps(w, cin_a)
    nb = conv_tc.n_block(cout)
    kca, kcb, nz = -(-cin_a // KCH), -(-cin_b // KCH), -(-cout // nb)
    assert laid.shape == (nz, kca + kcb, 9, KCH // 16, nb // 8, 8, 16)
    assert laid.dtype == torch.int8
    slots = laid.reshape(nz, kca + kcb, 9, KCH * nb)
    seen = torch.zeros(cout, cin_a + cin_b, 3, 3, dtype=torch.int32)
    for c0, cin, k0, kc in ((0, cin_a, 0, kca), (cin_a, cin_b, kca, kcb)):
        for z in range(nz):
            for c in range(kc):
                for tap in range(9):
                    back = torch.cat([_b_operand(slots[z, k0 + c, tap], nb, q)
                                      for q in range(KCH // 32)])
                    want = torch.zeros(KCH, nb, dtype=torch.int8)  # [ci in chunk, co in block]
                    src = w[nb * z:nb * z + nb, c0 + KCH * c:c0 + min(KCH * c + KCH, cin),
                            tap // 3, tap % 3]
                    want[:src.shape[1], :src.shape[0]] = src.T
                    assert torch.equal(back, want), (c0, z, c, tap)
                    seen[nb * z:nb * z + nb, c0 + KCH * c:c0 + min(KCH * c + KCH, cin),
                         tap // 3, tap % 3] += 1
    assert bool((seen == 1).all())


def _reflect(i, n):
    i = i.abs()
    i = torch.where(i >= n, 2 * (n - 1) - i, i)
    return i.clamp(0, n - 1)


def _k4_model(xa, xb, s_x, w_q):
    """A pure-torch model of K4's blocks, returning the int32 sums: per 16 x
    8-pixel tile, block of NB output channels and KCH-channel chunk, the
    staged rows (row i: 16-channel group i // PIXELS of staged pixel i %
    PIXELS, from its reflected or clamped source, quantized with ``s_x`` if
    float, zeros past cin) in one flat buffer; per tap and k32 step, A read
    through the shifted K-major descriptor, B through ``_b_operand``; the
    accumulator fragment of the wgmma D layout (thread ``lane`` of warp
    ``warp``, register ``i``: row ``16 warp + lane // 4 + 8 ((i // 2) % 2)``,
    column ``8 (i // 4) + 2 (lane % 4) + i % 2``) stored by the epilogue's
    formulas with the ragged edge and channels past cout masked."""
    b, h, w, ca = xa.shape
    cout = w_q.shape[0]
    nb = conv_tc.n_block(cout)
    slots = conv_tc.s8_taps(w_q, ca).long()
    nz, nchunks = slots.shape[:2]
    slots = slots.reshape(nz, nchunks, 9, -1)
    nca = -(-ca // KCH)
    i = torch.arange(ITEMS)
    g, p = i // PIXELS, i % PIXELS
    iy, ix = p // IN_W, p % IN_W
    m = torch.arange(64)[:, None]
    k = torch.arange(32)[None, :]
    # the epilogue: (warp, lane, register) -> (tile row, column, channel) and
    # the fragment's (row, column)
    warp, lane, reg = torch.meshgrid(torch.arange(4), torch.arange(32), torch.arange(nb // 2),
                                     indexing="ij")
    j, hh, e = reg // 4, (reg // 2) % 2, reg % 2
    frag_m = 16 * warp + lane // 4 + 8 * ((reg // 2) % 2)
    frag_n = 8 * (reg // 4) + 2 * (lane % 4) + reg % 2
    out = torch.zeros(b, h, w, cout, dtype=torch.long)
    for bi in range(b):
        for h0 in range(0, h, K["TILE_H"]):
            for w0 in range(0, w, K["TILE_W"]):
                sy, sx = _reflect(h0 - 1 + iy, h), _reflect(w0 - 1 + ix, w)
                for z in range(nz):
                    acc = torch.zeros(2, 64, nb, dtype=torch.long)
                    for c in range(nchunks):
                        x, kc = (xb, c - nca) if c >= nca else (xa, c)
                        ci = kc * KCH + 16 * g
                        ok = ci < x.shape[3]
                        vals = x[bi, sy[ok][:, None], sx[ok][:, None],
                                 ci[ok][:, None] + torch.arange(16)]
                        if vals.dtype != torch.int8:
                            vals = tq.quantize_with(vals, s_x)
                        buf = torch.zeros(ITEMS, 16, dtype=torch.long)
                        buf[ok] = vals.long()
                        buf = buf.reshape(-1)
                        for tap in range(9):
                            for wg in range(2):
                                a0 = ((8 * wg + tap // 3) * IN_W + tap % 3) * 16
                                for q in range(KCH // 32):
                                    a = buf[a0 + (2 * q + k // 16) * A_LBO + (m // 8) * A_SBO
                                            + 16 * (m % 8) + k % 16]
                                    acc[wg] += a @ _b_operand(slots[z, c, tap], nb, q)
                    for wg in range(2):
                        oy = h0 + 8 * wg + 2 * warp + hh
                        ox = w0 + lane // 4
                        co = z * nb + 8 * j + 2 * (lane % 4) + e
                        keep = (oy < h) & (ox < w) & (co < cout)
                        out[bi, oy[keep], ox[keep], co[keep]] = acc[wg][frag_m[keep],
                                                                       frag_n[keep]]
    return out


@pytest.mark.parametrize("dtype,b,h,w,ca,cb,cout", [
    ("int8", 1, 19, 11, 16, 32, 72),      # two inputs, a partial chunk and block, ragged
    ("float32", 1, 17, 9, 64, 0, 64),     # NB = 64, one ragged row and column
    ("bfloat16", 2, 5, 13, 48, 16, 136),  # two blocks of output channels, a short tile
])
def test_k4_model_of_its_tiles_matches_plain(dtype, b, h, w, ca, cb, cout):
    """The model of K4's blocks (``_k4_model``) gives the plain version's
    integer sum: two inputs, zero-filled channel groups, ragged tiles,
    partial blocks of output channels, and float inputs quantized as
    staged (values on the .5 ties and past +-127 included)."""
    rng = np.random.default_rng(ca + cout)
    s_x = torch.tensor(np.float32(0.0625))

    def draw(c):
        if dtype == "int8":
            return torch.from_numpy(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8))
        halves = rng.integers(-300, 301, (b, h, w, c)).astype(np.float32) / 2  # ties, saturation
        return (torch.from_numpy(halves) * s_x).to(getattr(torch, dtype))

    xa, xb = draw(ca), draw(cb) if cb else None
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, ca + cb, 3, 3), dtype=np.int8))
    got = _k4_model(xa, xb, s_x, wq)
    codes = [p if p.dtype == torch.int8 else tq.quantize_with(p, s_x) for p in (xa, xb)
             if p is not None]
    want = qconv3x3_plain(codes[0], torch.tensor(1.0), wq, torch.ones(cout), None,
                          codes[1] if cb else None)
    assert int(got.abs().max()) < 2 ** 24
    assert torch.equal(got.float(), want)


SITES = [(64, 128, 256), (64, 0, 128), (128, 128, 128), (128, 0, 64), (64, 64, 256)]


@pytest.mark.parametrize("scale", ["dynamic", "static"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", SITES, ids=lambda s: "-".join(map(str, s)))
def test_float_input_plain_matches_quantize_then_int8_and_jax(site, dtype, out, scale):
    """K4's plain version on a float input (what K4 computes on the card):
    bit-equal to ``quantize_with`` + ``qconv3x3_plain`` on the codes, and to
    JAX's ``qconv2d`` with its dynamic or a static ``s_x``: JAX's codes equal
    (static ``s_x = 2^-4``, inputs on the .5 ties and past +-127; dynamic,
    codes at +-127), and each side's output its own rounding of the same
    exact int32 sum (the port's fused, JAX's here separate)."""
    cin_a, cin_b, cout = site
    rng = np.random.default_rng(sum(site))
    wgt, bias = _weights(cin_a + cin_b, cout, cout)
    jqp = _jqp(wgt, bias)
    tqp = _tqp(jqp)
    if scale == "static":
        s = np.float32(0.0625)
        x = rng.integers(-300, 301, (2, 4, 5, cin_a + cin_b)).astype(np.float32) / 2 * s
        jqp = {**jqp, "s_x": jnp.float32(s)}
        tqp = {**tqp, "s_x": torch.tensor(s)}
    else:
        x = (rng.standard_normal((2, 4, 5, cin_a + cin_b)) * 2).astype(np.float32)
    tdt, odt = getattr(torch, dtype), getattr(torch, out)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(tdt)
    parts = (tx[..., :cin_a].contiguous(), tx[..., cin_a:].contiguous()) if cin_b else (tx,)

    got = tq.qconv2d(parts if cin_b else tx, tqp, out_dtype=odt)
    if scale == "static":
        s_x = tqp["s_x"]
        want_codes = jax.jit(jq.quantize_with)(jx, jqp["s_x"])
    else:
        want_codes, want_s = jax.jit(jq.quantize_activation)(jx)
        s_x = tq._dynamic_scale(parts)
        assert float(s_x) == float(want_s)
    codes = tuple(tq.quantize_with(p, s_x) for p in parts)
    assert torch.equal(torch.cat(codes, -1), torch.from_numpy(np.array(want_codes)))
    if scale == "static":
        assert int(torch.cat(codes, -1).abs().max()) == 127
        assert int((torch.cat(codes, -1) % 2 == 0).sum()) > 0  # ties went to even codes
    else:
        assert int(torch.cat(codes, -1).abs().max()) == 127
    # bit-equal to quantize_with + the integer conv, through the plain version
    # and the CPU wrapper (float input)
    split = (parts[0], parts[1] if cin_b else None)
    args = (s_x, tqp["w_q"], tqp["s_w"], tqp["bias"])
    twice = qconv3x3_plain(codes[0], *args, codes[1] if cin_b else None, odt)
    assert torch.equal(got, twice)
    assert torch.equal(qconv3x3_plain(split[0], *args, split[1], odt), twice)
    assert torch.equal(qconv3x3(split[0], *args, split[1], odt), twice)
    # against JAX: each side its own rounding of the exact sum
    unit = qconv3x3_plain(codes[0], torch.tensor(1.0), tqp["w_q"], torch.ones(cout), None,
                          codes[1] if cin_b else None)
    want = jax.jit(jq.qconv2d, static_argnames=("out_dtype",))(jx, jqp,
                                                              out_dtype=getattr(jnp, out))
    fused, separate = _dequant(unit.numpy().astype(np.int64),
                               np.float32(s_x) * np.asarray(jqp["s_w"]), bias)
    fused, separate = (torch.from_numpy(v).to(odt) for v in (fused, separate))
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(odt)
    assert torch.equal(got, fused) and torch.equal(want, separate)


def _abs_bits(t):
    """|t| as the kernel compares it: the float32 bits with the sign cleared
    (a bfloat16 as the upper half of a float32)."""
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32) << 16) & 0x7FFFFFFF
    return t.numpy().view(np.uint32) & 0x7FFFFFFF


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["one", "two", "zero", "ragged", "reciprocal"])
def test_act_scale_plain_matches_dynamic_scale_and_jax(dtype, case):
    """The scale kernel's plain version equals ``_dynamic_scale`` (which the
    pools call; the CPU wrapper takes the plain version) and JAX's
    ``quantize_activation`` scale of the concat, a zero tensor's 1 included,
    and so does a numpy model of the kernel's arithmetic: the largest |x| as
    unsigned bits, one float32 product with f32(1 / 127), 0 -> 1. In
    "reciprocal" max |x| = 0.8125, where that product and a true division by
    127 round apart."""
    rng = np.random.default_rng(12)
    shapes = {"one": [(2, 9, 12, 48)], "two": [(2, 6, 7, 16), (2, 6, 7, 32)],
              "zero": [(1, 4, 5, 16)], "ragged": [(3, 5, 7, 3), (3, 5, 7, 5)],
              "reciprocal": [(2, 3, 4, 16)]}[case]
    xs = [(rng.standard_normal(s) * (1 + 3 * i)).astype(np.float32) * (case != "zero")
          for i, s in enumerate(shapes)]
    if case == "reciprocal":
        xs[0] = np.clip(xs[0], -0.5, 0.5)
        xs[0][1, 2, 3, 4] = -0.8125
        assert np.float32(0.8125) / np.float32(127) != np.float32(0.8125) * (
            np.float32(1) / np.float32(127))
    tdt = getattr(torch, dtype)
    parts = tuple(torch.from_numpy(x).to(tdt) for x in xs)
    _, want = jax.jit(jq.quantize_activation)(
        jnp.concatenate([jnp.asarray(x, getattr(jnp, dtype)) for x in xs], -1))
    got = tq.act_scale_plain(parts)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(want) == float(tq._dynamic_scale(parts)) == float(
        tq.act_scale(parts))
    amax = max(int(_abs_bits(p).max()) for p in parts)
    model = np.uint32(amax).view(np.float32) * (np.float32(1) / np.float32(127))
    assert float(got) == (1.0 if model == 0 else float(model))
    if case == "zero":
        assert float(got) == 1.0


def test_qconv3x3_checks_and_refuses_grad():
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = torch.zeros(8, 16, 3, 3, dtype=torch.int8)
    one = torch.tensor(1.0)
    with pytest.raises(TypeError, match="int8"):
        qconv3x3(x.half(), one, w, torch.ones(8))
    with pytest.raises(TypeError, match="one dtype"):
        qconv3x3(x, one, torch.zeros(8, 32, 3, 3, dtype=torch.int8), torch.ones(8), xb=x.float())
    with pytest.raises(ValueError, match="OIHW"):
        qconv3x3(x, one, w[:, :8], torch.ones(8))
    with pytest.raises(ValueError, match="scalar"):
        qconv3x3(x, torch.ones(1), w, torch.ones(8))
    with pytest.raises(TypeError, match="out_dtype"):
        qconv3x3(x, one, w, torch.ones(8), out_dtype=torch.float16)
    s_w = torch.ones(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="without a backward"):
        qconv3x3(x, one, w, s_w)
    with torch.no_grad():
        assert qconv3x3(x, one, w, s_w).shape == (1, 4, 4, 8)
