"""The port's int8 primitives (``v2e2v_tpu_torch/ops/qconv.py``) and kernel
K4's plain version and tap layout (``ops/cuda/qconv.py``,
``ops/cuda/conv_tc.imma_taps``) against the JAX package's ``ops/qconv.py``.

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


@pytest.mark.parametrize("cin_a,cin_b,cout", [(64, 128, 256), (64, 0, 128), (128, 128, 128),
                                              (16, 32, 72), (48, 0, 8)])
def test_imma_taps_hold_every_b_fragment(cin_a, cin_b, cout):
    """K4's taps, read back through the ``mma.sync`` m16n8k32 B-fragment
    mapping (lane ``g = lane // 4``, ``t = lane % 4``; register 0 holds K rows
    ``4t .. 4t + 3`` of column g, register 1 rows ``16 + 4t ..``), give back
    every weight once, zeros past cin and cout, in the source's chunk and
    block sizes."""
    assert (K["KC"], K["NBLK"], K["TH"], K["TW"]) == (conv_tc.IMMA_KC, conv_tc.IMMA_CO, 8, 16)
    rng = np.random.default_rng(cin_a + cout)
    w = torch.from_numpy(rng.integers(-127, 128, (cout, cin_a + cin_b, 3, 3), dtype=np.int8))
    laid = conv_tc.imma_taps(w, cin_a)
    kca, kcb, nc = -(-cin_a // 32), -(-cin_b // 32), -(-cout // 64)
    assert laid.shape == (nc, kca + kcb, 9, 4, 32, 16) and laid.dtype == torch.int8
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for part, (c0, cin, k0, kc) in enumerate(((0, cin_a, 0, kca), (cin_a, cin_b, kca, kcb))):
        for z in range(nc):
            for c in range(kc):
                for tap in range(9):
                    back = torch.zeros(64, 32, dtype=torch.int8)  # [co in block, ci in chunk]
                    for q in range(4):
                        frag = laid[z, k0 + c, tap, q]  # [lane, 16 bytes]
                        for h in range(2):
                            for r in range(2):  # register 0 and 1 of n-tile 2q + h
                                for e in range(4):
                                    back[16 * q + 8 * h + g, 16 * r + 4 * t + e] = \
                                        frag[:, 8 * h + 4 * r + e]
                    want = torch.zeros(64, 32, dtype=torch.int8)
                    src = w[64 * z:64 * z + 64, c0 + 32 * c:c0 + min(32 * c + 32, cin),
                            tap // 3, tap % 3]
                    want[:src.shape[0], :src.shape[1]] = src
                    assert torch.equal(back, want), (part, z, c, tap)


def test_k4_model_of_its_tiles_matches_plain():
    """A pure-torch model of K4's block: the haloed 10 x 18-pixel tile staged
    with the source's reflect/clamp index arithmetic and 48-byte pixel pitch,
    each chunk's A fragments read at (row warp + dy, column g + dx [+ 8]),
    the B fragments from ``imma_taps``, the C fragments stored at (column g
    [+ 8], channel 8 j + 2 t [+ 1]) with the ragged edge masked, equals the
    plain version's integer sum: two inputs, a zero-filled half chunk,
    ragged tiles and a partial block of output channels."""
    rng = np.random.default_rng(11)
    b, h, w, ca, cb, cout = 1, 11, 19, 16, 32, 72
    xa = torch.from_numpy(rng.integers(-127, 128, (b, h, w, ca), dtype=np.int8))
    xb = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cb), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, ca + cb, 3, 3), dtype=np.int8))
    taps = conv_tc.imma_taps(wq, ca).long()
    th, tw, pitch = K["TH"], K["TW"], K["PIX_BYTES"]
    ih, iw = th + 2, tw + 2  # the staged tile with its halo

    def reflect(i, n):
        i = i.abs()
        i = torch.where(i >= n, 2 * (n - 1) - i, i)
        return i.clamp(0, n - 1)

    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    out = torch.zeros(b, h, w, cout, dtype=torch.long)
    nca = -(-ca // 32)
    nchunks = nca + -(-cb // 32)
    for h0 in range(0, h, th):
        for w0 in range(0, w, tw):
            ys = reflect(h0 - 1 + torch.arange(ih), h)
            xs = reflect(w0 - 1 + torch.arange(iw), w)
            for z in range(taps.shape[0]):
                acc = torch.zeros(th, 8, 32, 4, dtype=torch.long)
                for c in range(nchunks):
                    x, ci0 = (xb, (c - nca) * 32) if c >= nca else (xa, c * 32)
                    stage = torch.zeros(ih * iw, pitch, dtype=torch.long)
                    for half in range(2):
                        if ci0 + 16 * half < x.shape[3]:
                            rows = x[0][ys][:, xs, ci0 + 16 * half:ci0 + 16 * half + 16]
                            stage[:, 16 * half:16 * half + 16] = rows.reshape(ih * iw, 16)
                    for warp in range(th):
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            p0 = (warp + dy) * iw + g + dx
                            a = torch.zeros(16, 32, dtype=torch.long)
                            for r, (pix, k0) in enumerate(((p0, 0), (p0 + 8, 0), (p0, 16),
                                                           (p0 + 8, 16))):
                                for e in range(4):
                                    a[g + 8 * (r % 2), k0 + 4 * t + e] = stage[pix, k0 + 4 * t + e]
                            for j in range(8):
                                q, hh = divmod(j, 2)
                                bm = torch.zeros(32, 8, dtype=torch.long)
                                for r in range(2):
                                    for e in range(4):
                                        bm[16 * r + 4 * t + e, g] = taps[z, c, tap, q, :,
                                                                         8 * hh + 4 * r + e]
                                cm = a @ bm
                                acc[warp, j] += torch.stack(
                                    [cm[g, 2 * t], cm[g, 2 * t + 1], cm[g + 8, 2 * t],
                                     cm[g + 8, 2 * t + 1]], -1)
                for warp in range(th):
                    if h0 + warp >= h:
                        continue
                    for j in range(8):
                        for half in range(2):
                            for ln in range(32):
                                co = 64 * z + 8 * j + 2 * int(t[ln])
                                ox = w0 + int(g[ln]) + 8 * half
                                if co < cout and ox < w:
                                    out[0, h0 + warp, ox, co:co + 2] = acc[warp, j, ln,
                                                                           2 * half:2 * half + 2]
    want = qconv3x3_plain(xa, torch.tensor(1.0), wq, torch.ones(cout), None, xb)
    assert torch.equal(out.float(), want)


def test_qconv3x3_checks_and_refuses_grad():
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = torch.zeros(8, 16, 3, 3, dtype=torch.int8)
    one = torch.tensor(1.0)
    with pytest.raises(TypeError, match="int8"):
        qconv3x3(x.float(), one, w, torch.ones(8))
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
