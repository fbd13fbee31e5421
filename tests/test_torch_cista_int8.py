"""int8 inference in the port (``CistaConfig.quant="int8"``: the int8 steps,
calibration, the drift gate, the sequence and the pool) against the JAX
package, at 32x40, C = 16, depth 2, batch 2, on weights carried across by
``export_torch_state_dict`` and voxel grids from numpy.

The JAX steps run jitted. Quantization is bit-equal on equal inputs
(``tests/test_torch_qconv.py``); the float convs (heads, CISTA-TC's attention
projections, upsample/final) and the dequant differ from JAX's by float32
rounding, about 1e-7 here. That difference moves a code only where a conv
input lies on a rounding tie (``test_code_flips_only_at_ties``); one flipped
code moves that conv's outputs in a 3x3 window by up to ``s_x * max|w|``
(about 1e-3 at these widths), and the recurrence spreads it over the map in
later convs and steps. So whole steps are held to max |diff| <= 2e-2 and
mean |diff| <= 1e-3 over three steps (seen: 1e-7 without a flip; 9e-3 and
2.5e-4 after one), far inside JAX's own int8-vs-float bounds (mean 0.03,
``tests/test_qconv.py``). Calibrated scales are held to rtol 1e-6: a site's
largest input can differ by an ulp through the float convs before it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.ops import fused as jfused
from v2e2v_tpu.ops import qconv as jq
from v2e2v_tpu.serving import StreamPool as JPool
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.ops import qconv as tq
from v2e2v_tpu_torch.serving import StreamPool
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax, save_checkpoint

H, W, C, NB, DEPTH, B = 32, 40, 16, 5, 2, 2
INIT = {"cista-lstc": jcista.init_cista_lstc, "cista-tc": jcista.init_cista_tc}
MAX_TOL, MEAN_TOL = 2e-2, 1e-3


def _cfgs(mode, **kw):
    common = dict(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB, model_mode=mode,
                  quant="int8")
    return (jcista.CistaConfig(**common, **{"fullres_impl": "ref", **kw}),
            tcista.CistaConfig(**common, **kw))


def _weights(mode):
    params = jax.tree_util.tree_map(np.asarray, INIT[mode](jax.random.PRNGKey(0), _cfgs(mode)[0]))
    return params, params_from_jax(params, DEPTH, mode)


@functools.lru_cache(maxsize=None)
def _fused_kernels(mode):
    """JAX's fused full-resolution kernels, made once (its eager folds take
    seconds, and inside a jitted step they make its compile slow)."""
    return jfused.precompute_fused_kernels(_weights(mode)[0])


def _voxels(steps=3, seed=1):
    return np.random.default_rng(seed).standard_normal((steps, B, H, W, NB)).astype(np.float32)


def _to_port(node):
    """A JAX quantized-params tree in the port's layout (w_q OIHW)."""
    if isinstance(node, dict):
        return {k: torch.from_numpy(np.asarray(v).transpose(3, 2, 0, 1).copy()) if k == "w_q"
                else _to_port(v) for k, v in node.items()}
    return torch.tensor(np.asarray(node))


def _site(qp, site):
    for k in site.split("."):
        qp = qp[k]
    return qp


@functools.lru_cache(maxsize=None)
def _jax_calibrated(mode):
    """JAX's quantized weights and static scales of ``_weights(mode)`` on
    ``_voxels()`` (the reference-shaped path), made once."""
    params = _weights(mode)[0]
    return _jax_static(params, _cfgs(mode)[0], _voxels())


def _jax_static(params, jcfg, vox):
    """JAX's quantized weights and its static scales (margin 1.25)
    calibrated on ``vox``, the reconstructions fed back."""
    jqp = jax.jit(lambda p: jq.quantize_core(p, jcfg.model_mode))(params)

    def run_steps():
        s, pv = jcista.cista_zero_state(jcfg, B), jnp.zeros((B, H, W, 1))
        for ev in vox:
            pv, s = jcista.get_step_fn(jcfg)({**params, "_quant": jqp}, jcfg, jnp.asarray(ev),
                                             pv, s)

    return jqp, jq.calibrate_step_scales(run_steps, jqp, model_mode=jcfg.model_mode,
                                         depth=DEPTH, margin=1.25)


def _run_both(params, sd, jcfg, tcfg, jqp, vox):
    """Both steps over ``vox`` with the reconstructions fed back; yields per
    step the port's and JAX's (reconstruction, cell, z, dg h, dg c)."""
    jstep = jax.jit(lambda p, ev, pv, st: jcista.get_step_fn(jcfg)(p, jcfg, ev, pv, st))
    jp = {**params, "_quant": jqp}
    if jcfg.fullres_impl == "fused":
        jp["_fullres_fused"] = _fused_kernels(jcfg.model_mode)
    tp = tcista.with_derived({**sd, "_quant": _to_port(jqp)}, tcfg, torch.float32)
    js, jpv = jcista.cista_zero_state(jcfg, B), jnp.zeros((B, H, W, 1))
    ts, tpv = tcista.cista_zero_state(tcfg, B, device="cpu"), torch.zeros((B, H, W, 1))
    for ev in vox:
        jpv, js = jstep(jp, jnp.asarray(ev), jpv, js)
        tpv, ts = tcista.get_step_fn(tcfg)(tp, tcfg, torch.from_numpy(ev), tpv, ts)
        yield ([t.numpy() for t in (tpv, ts.cell, ts.z, *ts.dg)],
               [np.asarray(t) for t in (jpv, js.cell, js.z, *js.dg)])


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        d = np.abs(g - w)
        assert d.max() <= MAX_TOL and d.mean() <= MEAN_TOL, (d.max(), d.mean())


CASES = [(m, f, s) for m in INIT for f in ("ref", "fused") for s in ("dynamic", "static", "chain")
         if not (m == "cista-tc" and s == "chain")]


@pytest.mark.parametrize("mode,fullres,scales", CASES, ids=["-".join(c) for c in CASES])
def test_int8_step_matches_jax(mode, fullres, scales):
    """Three steps of the int8 step, dynamic scales, static scales, and static
    scales with the requant chain (CISTA-LSTC), both full-resolution paths:
    the reconstruction and all four state tensors. The static scales are
    JAX's, calibrated on the reference-shaped path, on both sides."""
    params, sd = _weights(mode)
    vox = _voxels()
    jcfg, tcfg = _cfgs(mode, fullres_impl=fullres, requant_chain=scales == "chain")
    assert tcista.get_step_fn(tcfg).__name__ == jcista.get_step_fn(jcfg).__name__
    jqp, jstatic = _jax_calibrated(mode)
    for got, want in _run_both(params, sd, jcfg, tcfg, jqp if scales == "dynamic" else jstatic,
                               vox):
        _assert_close(got, want)
        assert np.all((got[0] >= 0) & (got[0] <= 1))


def _recorders(monkeypatch):
    """Record every int8 conv site's real-valued input and scale on both
    sides, in call order: JAX's traced (returned from the jitted step), the
    port's as tensors."""
    jrec, trec = [], []
    jconv = jq.qconv2d

    def jrecord(x, qp, *a, **k):
        s = qp.get("s_x")
        if s is None:
            s = jnp.max(jnp.abs(x)).astype(jnp.float32) / 127.0
            s = jnp.where(s == 0, 1.0, s)
        jrec.append((x.astype(jnp.float32), s))
        return jconv(x, qp, *a, **k)

    tconv = tq.qconv2d

    def trecord(x, qp, *a, **k):
        parts = tq._parts(x)
        s = qp.get("s_x")
        trec.append((torch.cat(parts, -1).float(), s if s is not None else tq._dynamic_scale(parts)))
        return tconv(x, qp, *a, **k)

    monkeypatch.setattr(jq, "qconv2d", jrecord)
    monkeypatch.setattr(tq, "qconv2d", trecord)
    monkeypatch.setattr(tcista, "qconv2d", trecord)
    return jrec, trec


def test_code_flips_only_at_ties(monkeypatch):
    """CISTA-LSTC with static scales over three steps (the case whose voxel
    grids flip a code). Fed JAX's input, the port's quantizer gives JAX's
    codes at every site: no flip. In the free run, the sites' inputs differ
    by float32 rounding alone (<= 1e-5) up to the first flipped code, and
    each code flipped there lies on a tie: JAX's ``x / s_x`` within 1e-4 of a
    half-integer. The flips per site are counted in call order."""
    mode = "cista-lstc"
    params, sd = _weights(mode)
    vox = _voxels()
    jcfg, tcfg = _cfgs(mode)
    jqp, jstatic = _jax_calibrated(mode)
    jrec, trec = _recorders(monkeypatch)
    sites = tq._SITE_ORDERS[mode](DEPTH)

    def jstep(p, ev, pv, st):
        del jrec[:]
        out = jcista.get_step_fn(jcfg)(p, jcfg, ev, pv, st)
        return out, list(jrec)

    jstep = jax.jit(jstep)
    jp = {**params, "_quant": jstatic}
    tp = tcista.with_derived({**sd, "_quant": _to_port(jstatic)}, tcfg, torch.float32)
    js, jpv = jcista.cista_zero_state(jcfg, B), jnp.zeros((B, H, W, 1))
    ts, tpv = tcista.cista_zero_state(tcfg, B, device="cpu"), torch.zeros((B, H, W, 1))
    flips, diverged = [], False
    for ev in vox:
        (jpv, js), jsites = jstep(jp, jnp.asarray(ev), jpv, js)
        del trec[:]
        tpv, ts = tcista.get_step_fn(tcfg)(tp, tcfg, torch.from_numpy(ev), tpv, ts)
        assert len(jsites) == len(trec) == len(sites)
        for name, (jx, js_x), (tx, ts_x) in zip(sites, jsites, trec):
            jx, js_x = np.asarray(jx), np.float32(js_x)
            assert float(ts_x) == js_x  # static scales
            want = np.asarray(jnp.clip(jnp.round(jx / js_x), -127, 127)).astype(np.int8)
            fed = tq.quantize_with(torch.from_numpy(jx.copy()), torch.tensor(js_x)).numpy()
            np.testing.assert_array_equal(fed, want, err_msg=name)
            got = tq.quantize_with(tx, ts_x).numpy()
            flipped = got != want
            flips.append((name, int(flipped.sum())))
            if not diverged:
                assert np.abs(tx.numpy() - jx).max() <= 1e-5, name
                ratio = jx[flipped].astype(np.float64) / js_x
                assert np.all(np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) < 1e-4), name
                diverged = bool(flipped.any())
    assert diverged, f"no code flipped: {flips}"  # the case is chosen to show one


@pytest.mark.parametrize("mode", list(INIT))
def test_calibrate_step_scales_matches_jax(mode):
    params, sd = _weights(mode)
    vox = _voxels()
    jcfg, tcfg = _cfgs(mode)
    _, jstatic = _jax_calibrated(mode)
    p = tcista.with_derived(sd, tcfg, torch.float32)
    qp = p["_quant"]

    def run_steps():
        s, pv = tcista.cista_zero_state(tcfg, B, device="cpu"), torch.zeros((B, H, W, 1))
        for ev in vox:
            pv, s = tcista.get_step_fn(tcfg)(p, tcfg, torch.from_numpy(ev), pv, s)

    got = tq.calibrate_step_scales(run_steps, qp, model_mode=mode, depth=DEPTH, margin=1.25)
    for site in set(tq._SITE_ORDERS[mode](DEPTH)):
        s = _site(got, site)["s_x"]
        assert s.dtype == torch.float32 and s.dim() == 0
        np.testing.assert_allclose(float(s), float(_site(jstatic, site)["s_x"]), rtol=1e-6)
        assert "s_x" not in _site(qp, site)  # the input is not changed
    with pytest.raises(ValueError, match="multiple of"):
        tq.calibrate_step_scales(lambda: None, qp, model_mode=mode, depth=DEPTH)


@pytest.mark.parametrize("shift", ["calibrated", "saturated"])
def test_drift_check_matches_jax(shift):
    """``int8_static_drift_check`` on one step: the SSIM delta and the verdict
    of JAX's, with the scales as calibrated and 100x below them (every site
    saturates; the case of ``tests/test_qconv.py``, whose amplified decoder
    tail gives the random-init reconstruction structure for SSIM to see)."""
    mode = "cista-lstc"
    jcfg, tcfg = _cfgs(mode)
    params = jax.tree_util.tree_map(np.asarray, INIT[mode](jax.random.PRNGKey(0), jcfg))
    for name, f in (("upsamp_conv", 4.0), ("final_conv", 50.0)):
        params[name] = {k: v * f if k == "weight" else v for k, v in params[name].items()}
    sd = params_from_jax(params, DEPTH, mode)
    ev = np.random.default_rng(1).standard_normal((1, H, W, NB)).astype(np.float32)
    jcfg1 = dataclasses.replace(jcfg)
    jqp = jax.jit(lambda p: jq.quantize_core(p, mode))(params)
    jstate, jprev = jcista.cista_zero_state(jcfg1, 1), jnp.zeros((1, H, W, 1))
    jstatic = jq.calibrate_step_scales(
        lambda: jcista.cista_lstc_step_int8({**params, "_quant": jqp}, jcfg1, jnp.asarray(ev),
                                            jprev, jstate), jqp, depth=DEPTH, margin=1.1)
    if shift == "saturated":
        jstatic = jax.tree_util.tree_map_with_path(
            lambda path, v: v * 1e-2 if path[-1].key == "s_x" else v, jstatic)
    want = jcista.int8_static_drift_check({**params, "_quant": jstatic}, jcfg1, jnp.asarray(ev),
                                          jprev, jstate)
    got = tcista.int8_static_drift_check(
        {**sd, "_quant": _to_port(jstatic)}, tcfg, torch.from_numpy(ev), torch.zeros(1, H, W, 1),
        tcista.cista_zero_state(tcfg, 1, device="cpu"))
    assert got[1] == want[1] == (shift == "calibrated")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=1e-5)


def test_int8_sequence_matches_jax_and_never_takes_parity_io(monkeypatch):
    """``cista_sequence`` with int8 makes the int8 weights once from the
    weights as given and runs the int8 step; ``io_layout='parity'`` is not
    taken (the JAX package's ``quant == 'none'`` condition)."""
    mode = "cista-lstc"
    params, sd = _weights(mode)
    vox = _voxels()
    jcfg, tcfg = _cfgs(mode, fullres_impl="fused", io_layout="parity")
    params = {**params, "_fullres_fused": _fused_kernels(mode)}
    assert not tcista.parity_io(tcfg)
    assert tcista.parity_io(dataclasses.replace(tcfg, quant="none"))

    def refuse(*a, **k):
        raise AssertionError("the int8 sequence took the parity step")

    monkeypatch.setattr(tcista, "cista_lstc_step_parity", refuse)
    want, want_st = jax.jit(lambda p, v: jcista.cista_sequence(p, jcfg, v))(params,
                                                                            jnp.asarray(vox))
    got, got_st = tcista.cista_sequence(sd, tcfg, torch.from_numpy(vox))
    assert tuple(got.shape) == (3, B, H, W, 1)
    _assert_close([got.numpy(), *(t.numpy() for t in (got_st.cell, got_st.z, *got_st.dg))],
                  [np.asarray(want), *(np.asarray(t) for t in (want_st.cell, want_st.z,
                                                               *want_st.dg))])


@pytest.mark.parametrize("mode", list(INIT))
def test_int8_pool_with_calibrate_matches_jax_pool(mode):
    """``StreamPool(quant="int8")``: three steps with dynamic scales, then
    ``calibrate`` on the same grids (the same returned bool, the same scales,
    the requant chain adopted for CISTA-LSTC), then three more steps, each
    against JAX's pool. The scales within rtol 1e-5: JAX's pool makes its
    int8 weights outside jit, where ``/ 127`` is a true division, so some
    ``s_w`` are an ulp off the port's (and its jitted steps') and the sites'
    inputs move by a few ulps more than in ``calibrate_step_scales``'s test."""
    params, sd = _weights(mode)
    jcfg, tcfg = _cfgs(mode)
    jpool = JPool(jcfg, params, capacity=B, dtype=jnp.float32)
    pool = StreamPool(tcfg, sd, capacity=B, dtype=torch.float32, device="cpu")
    ids = [(jpool.attach(), pool.attach()) for _ in range(B)]
    vox = _voxels(3, seed=2)

    def serve(grids):
        for step in grids:
            want = jpool.step({j: step[i] for i, (j, _) in enumerate(ids)})
            got = pool.step({t: step[i] for i, (_, t) in enumerate(ids)})
            _assert_close([got[t] for _, t in ids], [want[j] for j, _ in ids])

    serve(vox)
    assert jpool.calibrate(jnp.asarray(vox)) is pool.calibrate(vox) is True
    assert pool.cfg.requant_chain == jpool.cfg.requant_chain == (mode == "cista-lstc")
    for site in set(tq._SITE_ORDERS[mode](DEPTH)):
        np.testing.assert_allclose(float(_site(pool.params["_quant"], site)["s_x"]),
                                   float(_site(jpool.params["_quant"], site)["s_x"]), rtol=1e-5)
    serve(_voxels(3, seed=3))


def test_int8_config_dispatch_derived_and_checkpoint(tmp_path):
    _, sd = _weights("cista-lstc")
    with pytest.raises(ValueError, match="quant"):
        tcista.CistaConfig(quant="int4")
    with pytest.raises(ValueError, match="qconv_impl"):
        tcista.CistaConfig(qconv_impl="triton")
    _, tcfg = _cfgs("cista-lstc")
    assert tcista.get_step_fn(tcfg) is tcista.cista_lstc_step_int8
    assert tcista.get_step_fn(dataclasses.replace(tcfg, model_mode="cista-tc")) \
        is tcista.cista_tc_step_int8
    assert "_quant" in tcista.DERIVED
    p = tcista.with_derived(sd, tcfg, torch.float32)
    qp = p["_quant"]
    assert qp["D"]["w_q"].dtype == torch.int8
    assert tcista.with_derived(p, tcfg, torch.float32)["_quant"] is qp  # injected: kept
    assert "_quant" not in tcista.with_derived(p, dataclasses.replace(tcfg, quant="none"),
                                               torch.float32)
    save_checkpoint(str(tmp_path / "m.pth.tar"), p, 1)
    saved = torch.load(tmp_path / "m.pth.tar", weights_only=False)["state_dict"]
    assert not any(k.startswith("_") for k in saved)
    # the plain version by name gives the kernel's plain result on the CPU
    ev = torch.from_numpy(_voxels(1)[0])
    st = tcista.cista_zero_state(tcfg, B, device="cpu")
    prev = torch.zeros(B, H, W, 1)
    a, _ = tcista.cista_lstc_step_int8(p, tcfg, ev, prev, st)
    b, _ = tcista.cista_lstc_step_int8(p, dataclasses.replace(tcfg, qconv_impl="plain"), ev,
                                       prev, st)
    assert torch.equal(a, b)
    # inference only: K4 refuses under autograd
    grad = {k: v.requires_grad_(True) if k == "W0.conv2d.weight" else v for k, v in p.items()}
    with pytest.raises(RuntimeError, match="without a backward"):
        tcista.cista_lstc_step_int8(grad, tcfg, ev, prev, st)
