"""The port's LPIPS (``v2e2v_tpu_torch/training/lpips.py``) and the losses and
train steps that add it, against ``v2e2v_tpu/training/lpips_jax.py`` and the
JAX steps on the CPU, on shared random VGG16 weights (the published ones are
not in the repository).

The weights are He-scaled (``1 / sqrt(9 C_in)``, as
``tests/test_evaluate.py``'s transcription draws them) so the activations
stay in range through the thirteen convs; a test writes them to torch files
in both layouts the loaders read: a bare torchvision ``vgg16`` checkpoint
(uniform heads) and ``{'vgg', 'lin'}`` with random non-negative heads.

Held: the loaded weights equal the JAX loader's exactly; the distance within
rtol 1e-5 and atol 1e-6 of JAX's at 2x32x32x1 and at 1x45x60x1, where the
pools floor (45x60 -> 22x30 -> 11x15 -> 5x7 -> 2x3; 2e-6 relative seen:
oneDNN's and XLA's float32 convs sum in other orders);
``many_to_one_loss(lpips_fn=...)``, plain and weighted, within 1e-5 relative
and its gradient to the prediction within 1e-4 of the largest entry (a
weight-0 sample's exactly 0); the E2V and V2E2V train steps with LPIPS at a
tiny CISTA (C = 4, depth 2, 32x32, T = 2, B = 2) against the JAX steps: loss
within 1e-5 relative (1e-7 seen), every weight gradient within 1e-3 of its
largest entry (2.2e-4 seen; 1e-6 without LPIPS). That looser bound is
LPIPS's own conditioning: the random CISTA's reconstruction is nearly flat
(0.537 to 0.540), where the unit normalisation of feature vectors with few
small positive channels amplifies float32 rounding; there both the JAX and
the port's float32 gradients of the distance lie up to 2.6e-2 of their
largest entry from a float64 evaluation, on uniform random images within
2e-6. And on the spatial axis, the loss of two column blocks (thread ranks)
equal to the whole image's, the blocks' gradients the whole image's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKeyNoise, no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from test_torch_spatial import on_thread_ranks
from test_torch_train_step import _run_jax, grad_keeper
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.models import emulator as jemu
from v2e2v_tpu.models import v2e2v as jv2e2v
from v2e2v_tpu.parallel import mesh as jmesh
from v2e2v_tpu.training import losses as jlosses
from v2e2v_tpu.training import lpips_jax as jlpips
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.models import emulator as temu
from v2e2v_tpu_torch.models import v2e2v as tv2e2v
from v2e2v_tpu_torch.training import losses as tlosses
from v2e2v_tpu_torch.training import lpips as tlpips
from v2e2v_tpu_torch.training import steps
from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS, params_from_jax

RTOL, ATOL = 1e-5, 1e-6  # the distance
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4  # the loss; a gradient, of its largest entry
STEP_GRAD_TOL = 1e-3  # a train step's weight gradient, of its largest entry (see below)
LAYOUTS = ["torchvision", "vgg_lin"]
CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]  # vgg16.features' convs
H, W, C, DEPTH, NB, T, B = 32, 32, 4, 2, 5, 2, 2


def random_vgg(seed: int = 0):
    """He-scaled random VGG16 convs (OIHW) and non-negative heads."""
    rng = np.random.default_rng(seed)
    convs, cin = [], 3
    for cout, n in jlpips._VGG_BLOCKS:
        for _ in range(n):
            convs.append((rng.normal(0, 1 / np.sqrt(9 * cin), (cout, cin, 3, 3)).astype(np.float32),
                          rng.normal(0, 0.05, cout).astype(np.float32)))
            cin = cout
    lins = [(0.1 * rng.random(c)).astype(np.float32) for c, _ in jlpips._VGG_BLOCKS]
    return convs, lins


def write_vgg(path, layout: str, seed: int = 0) -> str:
    """The random weights as a torch file in ``layout``: 'torchvision'
    (``features.N.*``) or 'vgg_lin' (``{'vgg': {N.*}, 'lin': {linI.model.1.weight}}``)."""
    convs, lins = random_vgg(seed)
    feats = {}
    for i, (w, b) in zip(CONV_IDX, convs):
        feats[f"{i}.weight"], feats[f"{i}.bias"] = torch.from_numpy(w), torch.from_numpy(b)
    if layout == "torchvision":
        ckpt = {f"features.{k}": v for k, v in feats.items()}
        ckpt["classifier.0.weight"] = torch.zeros(4, 4)  # the rest of vgg16, ignored
    else:
        ckpt = {"vgg": feats, "lin": {f"lin{i}.model.1.weight":
                                      torch.from_numpy(w.reshape(1, -1, 1, 1))
                                      for i, w in enumerate(lins)}}
    torch.save(ckpt, path)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips")
    return {layout: write_vgg(root / f"{layout}.pth", layout) for layout in LAYOUTS}


@functools.lru_cache(maxsize=None)
def _jax_params(path):
    return jlpips.load_params(path)


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape).astype(np.float32),
            rng.uniform(size=shape).astype(np.float32))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_params_matches_the_jax_loader(ckpts, layout):
    want = _jax_params(ckpts[layout])
    got = tlpips.load_params(ckpts[layout])
    assert len(got["convs"]) == len(want["convs"]) == 13
    for g, w in zip(got["convs"], want["convs"]):
        np.testing.assert_array_equal(g["weight"].numpy(), np.transpose(w["weight"], (3, 2, 0, 1)))
        np.testing.assert_array_equal(g["bias"].numpy(), w["bias"])
    for g, w, c in zip(got["lins"], want["lins"], tlpips.TAPS):
        assert g.shape == (c,)
        np.testing.assert_array_equal(g.numpy(), w)
    if layout == "torchvision":
        assert all(float(g[0]) == 1.0 / c for g, c in zip(got["lins"], tlpips.TAPS))
    converted = tlpips.from_jax_params(want)
    for g, w in zip(converted["convs"], got["convs"]):
        assert torch.equal(g["weight"], w["weight"]) and torch.equal(g["bias"], w["bias"])
    assert all(torch.equal(g, w) for g, w in zip(converted["lins"], got["lins"]))


def test_available_and_make_lpips_fn(ckpts, monkeypatch, tmp_path):
    monkeypatch.delenv("V2E2V_LPIPS_WEIGHTS", raising=False)
    assert not tlpips.available() and tlpips.make_lpips_fn(device="cpu") is None
    monkeypatch.setenv("V2E2V_LPIPS_WEIGHTS", str(tmp_path / "absent.pth"))
    assert not tlpips.available() and tlpips.make_lpips_fn(device="cpu") is None
    monkeypatch.setenv("V2E2V_LPIPS_WEIGHTS", ckpts["vgg_lin"])
    assert tlpips.available()
    fn = tlpips.make_lpips_fn(device="cpu")
    a, b = (torch.from_numpy(x) for x in _images(1, (2, 32, 32, 1)))
    assert float(fn(a, a)) == 0.0 and float(fn(a, b)) > 0.0
    torch.testing.assert_close(fn.per_sample(a, b).mean(), fn(a, b), rtol=1e-6, atol=0)
    # a path given outright, with no variable set
    monkeypatch.delenv("V2E2V_LPIPS_WEIGHTS")
    assert tlpips.make_lpips_fn(ckpts["torchvision"], device="cpu") is not None


@pytest.mark.parametrize("shape", [(2, 32, 32, 1), (1, 45, 60, 1), (2, 24, 40, 3)],
                         ids=["2x32x32x1", "1x45x60x1", "2x24x40x3"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_lpips_distance_matches_jax(ckpts, layout, shape):
    jp = _jax_params(ckpts[layout])
    tp = tlpips.load_params(ckpts[layout])
    a, b = _images(2, shape)
    want = float(jlpips.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b)))
    got = tlpips.lpips_distance(tp, torch.from_numpy(a), torch.from_numpy(b))
    assert want > 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)
    feats = tlpips.vgg_features(tp, torch.zeros(1, 3, *shape[1:3]))
    assert [tuple(f.shape[2:]) for f in feats] == [
        (shape[1] >> k, shape[2] >> k) for k in range(5)]


def _jax_lpips_fn(path):
    jp = _jax_params(path)
    return lambda p, t: jlpips.lpips_distance(jp, p, t)


def _loss_and_grad_jax(path, pred, gt, w):
    fn = _jax_lpips_fn(path)

    def loss(p):
        return jlosses.many_to_one_loss(p, jnp.asarray(gt), lpips_fn=fn,
                                        sample_weights=None if w is None else jnp.asarray(w))

    value, grad = jax.value_and_grad(loss)(jnp.asarray(pred))
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("weights", [None, [1.0, 0.0, 1.0]], ids=["plain", "weighted"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_many_to_one_loss_with_lpips_matches_jax(ckpts, layout, weights):
    pred, gt = _images(3, (3, 32, 32, 1))
    want_loss, want_grad = _loss_and_grad_jax(ckpts[layout], pred, gt, weights)
    fn = tlpips.make_lpips_fn(ckpts[layout], device="cpu")
    p = torch.from_numpy(pred).requires_grad_(True)
    w = None if weights is None else torch.tensor(weights)
    loss = tlosses.many_to_one_loss(p, torch.from_numpy(gt), w, lpips_fn=fn)
    loss.backward()
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    tol = GRAD_TOL * float(np.abs(want_grad).max())
    assert float(np.abs(p.grad.numpy() - want_grad).max()) <= tol
    without = tlosses.many_to_one_loss(torch.from_numpy(pred), torch.from_numpy(gt), w)
    assert float(loss) > float(without)  # the distance is in it
    if weights is not None:
        assert not p.grad[1].any() and p.grad[0].abs().max() > 0  # the weight-0 sample
        # a plain callable (no per_sample) runs on each sample alone: the same loss
        loose = tlosses.many_to_one_loss(torch.from_numpy(pred), torch.from_numpy(gt), w,
                                         lpips_fn=lambda a, b: fn(a, b))
        torch.testing.assert_close(loose, loss.detach(), rtol=1e-6, atol=0)


def test_lpips_on_the_spatial_axis_is_the_whole_images(ckpts):
    """Two column blocks on thread ranks: each rank's loss is the whole
    image's (LPIPS on the gathered image) and the blocks' gradients join to
    the whole image's."""
    fn = tlpips.make_lpips_fn(ckpts["vgg_lin"], device="cpu")
    pred, gt = (torch.from_numpy(x) for x in _images(4, (2, 32, 32, 1)))
    whole = pred.clone().requires_grad_(True)
    want = tlosses.many_to_one_loss(whole, gt, lpips_fn=fn)
    want.backward()

    def rank(shard):
        block = pred.chunk(2, 2)[shard.index].clone().requires_grad_(True)
        loss = tlosses.many_to_one_loss(block, gt.chunk(2, 2)[shard.index], shard=shard,
                                        lpips_fn=fn)
        loss.backward()
        return loss.detach(), block.grad

    got = on_thread_ranks(2, rank)
    for loss, _ in got:
        torch.testing.assert_close(loss, want.detach(), rtol=1e-6, atol=0)
    grad = torch.cat([g for _, g in got], 2)
    torch.testing.assert_close(grad, whole.grad, rtol=0, atol=1e-5 * float(whole.grad.abs().max()))


# ------------------------------------------------------------- train steps

def _weights():
    cfg = jcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                             fullres_impl="ref")
    params = jax.tree_util.tree_map(np.asarray, jcista.init_cista_lstc(jax.random.PRNGKey(0), cfg))
    tcfg = tcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                              ista_impl="plain", core_impl="layers")
    return cfg, params, tcfg, tcista.tie_weights(params_from_jax(params, DEPTH), tcfg)


def _assert_step(loss, jloss, sd, jgrads):
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for k in STEP_KEYS["cista-lstc"]:
        got = sd[k].grad.numpy()
        want = jgrads[k].reshape(got.shape)
        tol = STEP_GRAD_TOL * float(np.abs(want).max())
        assert float(np.abs(want).max()) > 0 and float(np.abs(got - want).max()) <= tol, k


def test_e2v_step_with_lpips_matches_jax(ckpts):
    cfg, params, tcfg, sd = _weights()
    rng = np.random.default_rng(5)
    seq = rng.normal(size=(T, B, H, W, NB)).astype(np.float32)
    gt = rng.uniform(size=(B, H, W, 1)).astype(np.float32)
    path = ckpts["vgg_lin"]
    jstep = jmesh.make_e2v_train_step(cfg, grad_keeper(), jmesh.make_mesh(1, 1),
                                      lpips_fn=_jax_lpips_fn(path))
    (_, _, jloss), jgrads = _run_jax(jstep, params, seq, gt)
    fn = tlpips.make_lpips_fn(path, device="cpu")
    opt = steps.make_adam(sd, tcfg, 1e-4)
    loss = steps.make_e2v_train_step(tcfg, opt, lpips_fn=fn)(sd, torch.from_numpy(seq),
                                                             torch.from_numpy(gt))
    _assert_step(loss, jloss, sd, jgrads)
    # the VGG weights are frozen: not the optimizer's, no gradient
    assert all(p.grad is None and not p.requires_grad
               for conv in fn.params["convs"] for p in conv.values())
    assert {id(p) for g in opt.param_groups for p in g["params"]}.isdisjoint(
        {id(p) for conv in fn.params["convs"] for p in conv.values()})


def test_v2e2v_step_with_lpips_matches_jax(ckpts):
    cfg, params, tcfg, sd = _weights()
    emu = dict(pos_thres=0.6, neg_thres=0.6, sigma_thres=0.03, pl=1.5, ps=0.5,
               cutoff_hz=200.0, ql=1.0, qs=0.0, refractory_period_s=0.001, leak_rate_hz=0.1,
               shot_noise_rate_hz=100.0, num_bins=NB)
    jcfg = jv2e2v.V2E2VConfig(cista=cfg, emulator=jemu.EmulatorConfig(**emu, iters_impl="xla"))
    tcfg = tv2e2v.V2E2VConfig(cista=dataclasses.replace(tcfg, core_impl="layers"),
                              emulator=temu.EmulatorConfig(**emu, iters_impl="cuda"))
    n = 4
    rng = np.random.default_rng(6)
    base = rng.uniform(2.0, 20.0, (B, 1, H, W)).astype(np.float32)
    rate = rng.uniform(-0.5, 0.5, (B, 1, H, W)).astype(np.float32)
    i = np.arange(T * (n - 1) + 1, dtype=np.float32).reshape(1, -1, 1, 1)
    video = np.clip(base * np.exp(rate * np.sin(i * 0.7)), 0, 20).astype(np.float32)
    t = np.arange(T * (n - 1) + 1, dtype=np.float32) * 0.004
    frames = np.stack([video[:, p * (n - 1):p * (n - 1) + n] for p in range(T)])
    ts = np.stack([np.tile(t[p * (n - 1):p * (n - 1) + n], (B, 1)) for p in range(T)])
    gt = rng.uniform(size=(B, H, W, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    path = ckpts["torchvision"]
    jstep = jmesh.make_v2e2v_train_step(jcfg, grad_keeper(), jmesh.make_mesh(1, 1),
                                        lpips_fn=_jax_lpips_fn(path))
    (_, _, jloss, jstats), jgrads = _run_jax(jstep, params, frames, ts, gt, key)
    opt = steps.make_adam(sd, tcfg.cista, 1e-4)
    loss, stats = steps.make_v2e2v_train_step(
        tcfg, opt, lpips_fn=tlpips.make_lpips_fn(path, device="cpu"))(
        sd, torch.from_numpy(frames), torch.from_numpy(ts), torch.from_numpy(gt),
        JaxKeyNoise(key))
    assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in jstats.items()}
    assert int(stats["num_events"]) > 100
    _assert_step(loss, jloss, sd, jgrads)
