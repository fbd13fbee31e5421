"""The port's spatial mesh axis (``v2e2v_tpu_torch/parallel/spatial.py``, the
E2V train steps on ``make_mesh(n_data, n_spatial)``) on the CPU.

- The halo exchange in one process: ranks as threads over an in-process
  sum (``ThreadHub``), each op on its block against the same op on the whole
  image, forward and backward, exact: the padding (reflect and replicate,
  halos of 1 and 2), the 2x bilinear upsample, a reflect conv of stride 1 and
  2, the plain ISTA loop.
- Ranks over ``gloo``, each a process of tests/_torch_dist_worker.py on one
  torch thread, at C = 8, depth 2, T = 3, a global batch of 4: the ``(1, 2)``
  and ``(2, 2)`` E2V and device-data steps against
  ``v2e2v_tpu/parallel/mesh.py``'s on ``make_mesh(1, 2)`` and ``make_mesh(2,
  2)`` (the suite's virtual CPU devices, ``fullres_impl="ref"``), on the
  same weights and batch, at 32x40 and 32x20 (a half-resolution block of 5
  columns): the loss to rtol 1e-6, each gradient to ``2e-5 * max |g|``
  (tests/test_torch_distributed.py's ``GRAD_TOL``). ``(1, 4)`` at 16x40
  against the port's one process: the last reconstruction within 1e-6, the
  same loss and gradient bounds, the device-data noise cut to a rank's rows
  and columns. One CISTA-TC case on ``(1, 2)``. Every rank holds the same
  reduced loss and gradients. A planted fault, the inner cut reflect-padded
  instead of exchanged, must fail the gradient bound.
- ``cli.train_e2v --mesh_spatial 2`` as two processes against one: the
  checkpoints within tests/test_torch_distributed.py's ``CKPT_TOL``, only
  rank 0 writes.
- The refusals: uneven widths, ``fullres_impl="fused"``, K1 and K2 on a
  sharded call, the V2E2V steps, ``StreamPool`` and ``cli.train`` on a
  spatial axis.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import free_port, no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from test_torch_distributed import (
    GRAD_TOL,
    WORKER,
    _assert_checkpoints_close,
    start_ranks,
    train_data,  # noqa: F401
    wait_ranks,
)
from test_torch_train_step import C, DEPTH, H, NB, T, _run_jax, _weights, grad_keeper
from v2e2v_tpu.parallel import mesh as jmesh
from v2e2v_tpu_torch.cli import train as ttrain
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.ops import conv as tconv
from v2e2v_tpu_torch.ops.cuda.core import cista_core, core_taps
from v2e2v_tpu_torch.ops.cuda.ista import ista_loop, ista_loop_plain
from v2e2v_tpu_torch.parallel import mesh as tmesh
from v2e2v_tpu_torch.parallel import spatial
from v2e2v_tpu_torch.serving import StreamPool
from v2e2v_tpu_torch.training import steps
from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
FWD_TOL = 1e-6
LAYOUTS = ((1, 2), (2, 2), (1, 4))


class ThreadHub:
    """An in-process spatial group: ranks as threads, ``all_reduce`` as the
    sum of every rank's buffer in rank order."""

    def __init__(self, n):
        self.n, self.slots, self.barrier = n, [None] * n, threading.Barrier(n)

    def reduce(self, index, buf):
        self.slots[index] = buf.clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for s in self.slots[1:]:
            total += s
        self.barrier.wait()
        buf.copy_(total)


@dataclasses.dataclass(frozen=True)
class ThreadShard(spatial.Shard):
    hub: ThreadHub = None

    def all_reduce(self, buf):
        self.hub.reduce(self.index, buf)


def on_thread_ranks(n, fn):
    """``fn(shard)`` on ``n`` thread ranks; their results in rank order."""
    hub, results, errors = ThreadHub(n), [None] * n, []

    def run(i):
        try:
            results[i] = fn(ThreadShard(None, i, n, hub))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def sharded_against_whole(n, op, x, dim):
    """``op(block, shard)`` on each of ``n`` blocks of ``x`` along ``dim``
    against ``op(x, None)``: the outputs and the gradients of a fixed random
    weighting of the output, each joined along ``dim``."""
    want_x = x.clone().requires_grad_(True)
    want = op(want_x, None)
    weight = torch.randn(want.shape, generator=torch.Generator().manual_seed(9))
    (want * weight).sum().backward()
    w_blocks = weight.chunk(n, dim)

    def rank(shard):
        block = x.chunk(n, dim)[shard.index].clone().requires_grad_(True)
        y = op(block, shard)
        (y * w_blocks[shard.index]).sum().backward()
        return y.detach(), block.grad

    got = on_thread_ranks(n, rank)
    return (torch.cat([g[0] for g in got], dim), want.detach(),
            torch.cat([g[1] for g in got], dim), want_x.grad)


def _halo_whole(x, p, mode):
    """One process's padding of the whole NHWC image along the width."""
    return F.pad(x.permute(0, 3, 1, 2), (p, p, 0, 0), mode=mode).permute(0, 2, 3, 1)


@pytest.mark.parametrize("mode", spatial.PAD_MODES)
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_halo_pad_is_the_whole_image_padding(mode, p, n):
    x = torch.randn(2, 3, 24, 5, generator=torch.Generator().manual_seed(1))
    # the padded blocks overlap: compare each with its window of the padded whole
    whole = _halo_whole(x, p, mode)
    w = x.shape[2] // n

    def op(block, shard):
        return spatial.halo_pad(block, p, mode, shard)

    got = on_thread_ranks(n, lambda s: op(x.chunk(n, 2)[s.index], s))
    for i, g in enumerate(got):
        assert torch.equal(g, whole[:, :, i * w:i * w + w + 2 * p]), i
    # backward: the halos' gradients go home
    weight = torch.randn(whole.shape, generator=torch.Generator().manual_seed(2))

    def rank(shard):
        block = x.chunk(n, 2)[shard.index].clone().requires_grad_(True)
        i = shard.index
        (op(block, shard) * weight[:, :, i * w:i * w + w + 2 * p]).sum().backward()
        return block.grad

    # each padded column's weight is its own window's: the overlaps count once per window
    got_grad = torch.cat(on_thread_ranks(n, rank), 2)
    want_grad = torch.zeros_like(x)
    for i in range(n):
        xi = x.clone().requires_grad_(True)
        (_halo_whole(xi, p, mode)[:, :, i * w:i * w + w + 2 * p]
         * weight[:, :, i * w:i * w + w + 2 * p]).sum().backward()
        want_grad += xi.grad
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-6, atol=1e-6)


def test_halo_pad_refuses_a_block_no_wider_than_its_halo():
    with pytest.raises(ValueError, match="wider than it"):
        on_thread_ranks(2, lambda s: spatial.halo_pad(torch.zeros(1, 2, 2, 1), 2, "reflect", s))
    with pytest.raises(ValueError, match="mode"):
        on_thread_ranks(2, lambda s: spatial.halo_pad(torch.zeros(1, 2, 4, 1), 1, "zeros", s))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_bilinear_and_convs_are_the_whole_image_ops(n):
    """Each op on its blocks against the op on the whole image: the same
    values (1e-6) and input gradients (1e-5 relative)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 40, 4, generator=g)
    conv = {"weight": torch.randn(5, 4, 3, 3, generator=g), "bias": torch.randn(5, generator=g)}
    ops = {
        "bilinear 2x": lambda t, s: tconv.bilinear_resize(t, 12, 2 * t.shape[2], shard=s),
        "conv stride 1": lambda t, s: tconv.conv2d(t, conv, padding=1, shard=s),
        "conv stride 2": lambda t, s: tconv.conv2d(t, conv, stride=2, padding=1, shard=s),
        "upsample conv": lambda t, s: tconv.upsample_conv_layer(
            t, {"weight": conv["weight"][:, :4], "bias": conv["bias"]}, activation="relu",
            shard=s),
    }
    for name, op in ops.items():
        y, y_want, gx, gx_want = sharded_against_whole(n, op, x, 2)
        torch.testing.assert_close(y, y_want, rtol=0, atol=FWD_TOL, msg=name)
        torch.testing.assert_close(gx, gx_want, rtol=1e-5, atol=1e-5 * float(gx_want.abs().max()),
                                   msg=name)


def test_sharded_plain_ista_loop_is_the_whole_image_loop():
    g = torch.Generator().manual_seed(4)
    x1, z = torch.randn(2, 6, 20, 4, generator=g), torch.randn(2, 6, 20, 8, generator=g)
    args = (torch.randn(3, 3, 8, 4, generator=g) * 0.2, torch.randn(4, generator=g),
            torch.randn(3, 3, 4, 8, generator=g) * 0.2, torch.randn(8, generator=g),
            torch.rand(8, generator=g) * 0.1)
    got = torch.cat(on_thread_ranks(2, lambda s: ista_loop_plain(
        x1.chunk(2, 2)[s.index].contiguous(), z.chunk(2, 2)[s.index].contiguous(), *args,
        depth=3, shard=s)), 2)
    torch.testing.assert_close(got, ista_loop_plain(x1, z, *args, depth=3), rtol=0,
                               atol=FWD_TOL)


def test_voxel_noise_of_a_block_is_the_global_draws():
    """``add_noise_to_voxel`` with ``rows`` and ``cols`` adds those rows and
    columns of the whole tensor's draws."""
    from v2e2v_tpu_torch.ops.voxel import add_noise_to_voxel

    voxel = torch.arange(2 * 4 * 3 * 8, dtype=torch.float32).reshape(2, 4, 3, 8)
    whole = add_noise_to_voxel(torch.Generator().manual_seed(2), voxel, 0.1, 1.0)
    block = add_noise_to_voxel(torch.Generator().manual_seed(2), voxel[:, 2:, :, 4:6], 0.1,
                               1.0, rows=(1, slice(2, 4), 4), cols=(3, slice(4, 6), 8))
    assert torch.equal(block, whole[:, 2:, :, 4:6])


def _case(name, layout, step, width, height=H, mode="cista-lstc", noise_std=0.0, fault=None,
          seed=11):
    """One E2V case for the ranks: the JAX package's ``PRNGKey(0)`` weights,
    a batch and a dataset of ``height x width`` made from ``seed``."""
    jcfg, params, tcfg, _ = _weights(mode)
    jcfg = dataclasses.replace(jcfg, image_dim=(height, width), fullres_impl="ref")
    tcfg = dataclasses.replace(tcfg, image_dim=(height, width))
    rng = np.random.default_rng(seed + width)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    u32 = lambda *s: torch.from_numpy(rng.uniform(size=s).astype(np.float32))  # noqa: E731
    return dict(
        name=name, layout=layout, step=step, fault=fault, noise_std=noise_std, noise_seed=7,
        cfg=tcfg, weights=params_from_jax(params, DEPTH, mode),
        seq=f32(T, B, height, width, NB), gt=u32(B, height, width, 1),
        data=f32(6, T, height, width, NB), gt_all=u32(6, height, width, 1),
        # a tail batch of 3 padded to 4: the padding on the last data index
        idx=torch.tensor([4, 1, 3, 3]), w=torch.tensor([1.0, 1.0, 1.0, 0.0]),
    ), (jcfg, params)


def _cases():
    jax_cases = [(f"{step}_{width}_{nd}x{ns}", (nd, ns), step, width)
                 for width in (40, 20) for nd, ns in LAYOUTS[:2]
                 for step in ("e2v", "device_data")]
    one_process = [("e2v_16x40_1x4", (1, 4), "e2v", 40, dict(height=16)),
                   ("device_data_noise_16x40_1x4", (1, 4), "device_data", 40,
                    dict(height=16, noise_std=0.1)),
                   ("tc_1x2", (1, 2), "e2v", 40, dict(mode="cista-tc")),
                   ("fault_1x2", (1, 2), "e2v", 40, dict(fault="reflect_inner_cuts"))]
    return ([_case(*c) for c in jax_cases],
            [_case(*c[:4], **c[4]) for c in one_process])


def _one_process(case):
    """The port's step in one process on the case's whole batch, and the
    forward's last reconstruction."""
    cfg = case["cfg"]
    sd = tcista.tie_weights({k: v.clone() for k, v in case["weights"].items()}, cfg)
    opt = steps.make_adam(sd, cfg, 1e-4)
    if case["step"] == "e2v":
        loss = steps.make_e2v_train_step(cfg, opt)(sd, case["seq"], case["gt"])
        with torch.no_grad():
            rec = tcista.cista_sequence(sd, cfg, case["seq"])[0][-1]
    else:
        loss = steps.make_e2v_train_step_device_data(cfg, opt, noise_std=case["noise_std"])(
            sd, case["data"], case["gt_all"], case["idx"],
            torch.Generator().manual_seed(case["noise_seed"]), case["w"])
        rec = None
    return {"loss": loss, "rec": rec,
            "grads": {k: sd[k].grad.clone() for k in STEP_KEYS[cfg.model_mode]}}


def _jax_step(case, jcfg, params):
    nd, ns = case["layout"]
    mesh = jmesh.make_mesh(nd, ns, devices=jax.devices("cpu")[:nd * ns])
    np_ = lambda t: np.array(t.numpy())  # noqa: E731
    if case["step"] == "e2v":
        step = jmesh.make_e2v_train_step(jcfg, grad_keeper(), mesh)
        (_, _, loss), grads = _run_jax(step, params, np_(case["seq"]), np_(case["gt"]))
    else:
        step = jmesh.make_e2v_train_step_device_data(jcfg, grad_keeper(), mesh)
        (_, _, loss), grads = _run_jax(step, params, np_(case["data"]), np_(case["gt_all"]),
                                       np_(case["idx"]).astype(np.int32),
                                       jax.random.PRNGKey(0), np_(case["w"]))
    return {"loss": float(loss), "grads": grads}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(case -> every rank's result, case -> JAX's, case -> one process's)``:
    the three layouts' ranks run while this process runs JAX's steps and the
    port's one-process steps."""
    workdir = tmp_path_factory.mktemp("spatial")
    jax_cases, port_cases = _cases()
    torch.save([c for c, _ in jax_cases + port_cases], workdir / "spatial_inputs.pt")
    procs = {layout: start_ranks("spatial", workdir, *map(str, layout),
                                 world=layout[0] * layout[1]) for layout in LAYOUTS}
    try:
        jax_out = {c["name"]: _jax_step(c, *j) for c, j in jax_cases}
        single = {c["name"]: _one_process(c) for c, _ in port_cases}
    finally:
        for p in procs.values():
            wait_ranks(p)
    ranks = {}
    for layout in LAYOUTS:
        outs = [torch.load(workdir / f"spatial_{layout[0]}x{layout[1]}_{r}.pt",
                           weights_only=False)
                for r in range(layout[0] * layout[1])]
        for name in outs[0]:
            ranks[name] = [o[name] for o in outs]
    return ranks, jax_out, single, {c["name"]: c for c, _ in jax_cases + port_cases}


def _grad_errors(got, want):
    """Each gradient's max |diff| over its tensor's largest entry."""
    out = {}
    for k, g in got.items():
        w = np.asarray(want[k]).reshape(g.shape)
        assert float(np.abs(w).max()) > 0, k
        out[k] = float(np.abs(g.numpy() - w).max()) / float(np.abs(w).max())
    return out


def _assert_same_on_every_rank(results):
    for r in results[1:]:
        assert float(r["loss"]) == float(results[0]["loss"])
        for k, g in results[0]["grads"].items():
            assert torch.equal(r["grads"][k], g), k


def _joined_rec(results, layout):
    """The ranks' blocks of the last reconstruction, as the whole batch."""
    nd, ns = layout
    return torch.cat([torch.cat([results[d * ns + s]["rec"] for s in range(ns)], 2)
                      for d in range(nd)], 0)


@pytest.mark.parametrize("name", [f"{step}_{width}_{nd}x{ns}" for width in (40, 20)
                                  for nd, ns in LAYOUTS[:2] for step in ("e2v", "device_data")])
def test_sharded_steps_match_jax_on_the_same_mesh(runs, name):
    ranks, jax_out, _, cases = runs
    _assert_same_on_every_rank(ranks[name])
    np.testing.assert_allclose(float(ranks[name][0]["loss"]), jax_out[name]["loss"], rtol=1e-6)
    errs = _grad_errors(ranks[name][0]["grads"], jax_out[name]["grads"])
    print(f"{name}: largest gradient difference {max(errs.values()):.3g} of the tensor's "
          "largest entry")
    assert max(errs.values()) <= GRAD_TOL, errs
    if cases[name]["step"] == "e2v":  # the blocks join into finite images
        rec = _joined_rec(ranks[name], cases[name]["layout"])
        assert rec.shape == (B, H, cases[name]["cfg"].image_dim[1], 1)
        assert torch.isfinite(rec).all()


@pytest.mark.parametrize("name", ["e2v_16x40_1x4", "device_data_noise_16x40_1x4", "tc_1x2"])
def test_sharded_steps_match_one_process(runs, name):
    ranks, _, single, cases = runs
    _assert_same_on_every_rank(ranks[name])
    want = single[name]
    np.testing.assert_allclose(float(ranks[name][0]["loss"]), float(want["loss"]), rtol=1e-6)
    errs = _grad_errors(ranks[name][0]["grads"], want["grads"])
    print(f"{name}: largest gradient difference {max(errs.values()):.3g} of the tensor's "
          "largest entry")
    assert max(errs.values()) <= GRAD_TOL, errs
    if want["rec"] is not None:
        rec = _joined_rec(ranks[name], cases[name]["layout"])
        err = float((rec - want["rec"]).abs().max())
        print(f"{name}: last reconstruction max |diff| {err:.3g}")
        torch.testing.assert_close(rec, want["rec"], rtol=0, atol=FWD_TOL)


def test_a_reflected_inner_cut_fails_the_bounds(runs):
    """The planted fault: every cut reflect-padded as an image edge."""
    ranks, _, single, cases = runs
    got, want = ranks["fault_1x2"], single["fault_1x2"]
    errs = _grad_errors(got[0]["grads"], want["grads"])
    rec_err = float((_joined_rec(got, (1, 2)) - want["rec"]).abs().max())
    print(f"fault: gradients {max(errs.values()):.3g}, last reconstruction {rec_err:.3g}")
    assert max(errs.values()) > 100 * GRAD_TOL, errs
    assert rec_err > 100 * FWD_TOL, rec_err


def test_trainer_sharded_over_two_processes_matches_one(train_data, tmp_path):  # noqa: F811
    """One epoch of ``cli.train_e2v --mesh_spatial 2`` as two ranks against one
    process (the default ``--mesh_data``: ``gcd(batch_size, 2 // 2) = 1``)."""
    name, epoch = "_cista-lstc_b5_d2_c8", 1
    flags = ["--path_to_train_data", str(train_data), "--image_dim", "32", "40", "-c", "8",
             "-d", "2", "--len_sequence", "3", "--num_events", "500", "--batch_size", "2",
             "--epochs", str(epoch), "--add_noise"]
    env = {**os.environ, "V2E2V_PLATFORM": "cpu", "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    one = subprocess.Popen([sys.executable, "-m", "v2e2v_tpu_torch.cli.train_e2v", *flags,
                            "--path_to_model", str(tmp_path / "one")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "train_e2v", str(r), "2", port, str(tmp_path), *flags,
         "--mesh_spatial", "2", "--path_to_model", str(tmp_path / f"rank{r}")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = wait_ranks(procs + [one])
    assert "distributed: process 0/2" in outs[0] and "warning: dropped" not in outs[0]
    # the first step's loss, as printed, is one process's
    first = [next(line for line in o.splitlines() if "loss:" in line) for o in (outs[0], outs[2])]
    assert first[0] == first[1], first
    got = torch.load(tmp_path / "rank0" / name / f"{name}_{epoch}.pth.tar", weights_only=False)
    want = torch.load(tmp_path / "one" / name / f"{name}_{epoch}.pth.tar", weights_only=False)
    assert not list((tmp_path / "rank1").rglob("*.pth.tar"))
    _assert_checkpoints_close(got, want)


def _sharded_mesh():
    return tmesh.Mesh((torch.device("cpu"),) * 2, group=object(), n_spatial=2, spatial_rank=1)


def _refuse_sharded_kernels():
    _, _, tcfg, sd = _weights("cista-lstc")
    x1, z = torch.zeros(1, 4, 4, C), torch.zeros(1, 4, 4, 2 * C)
    shard = spatial.Shard(None, 0, 2)
    with torch.no_grad():
        d = sd["lista_blocks.0.D.conv2d.weight"].permute(2, 3, 1, 0)
        p = sd["lista_blocks.0.P.conv2d.weight"].permute(2, 3, 1, 0)
        with pytest.raises(ValueError, match="ista_loop is a CUDA kernel over whole images"):
            ista_loop(x1, z, d, sd["lista_blocks.0.D.conv2d.bias"], p,
                      sd["lista_blocks.0.P.conv2d.bias"], torch.zeros(2 * C), depth=DEPTH,
                      shard=shard)
        with pytest.raises(ValueError, match="cista_core is a CUDA kernel over whole images"):
            cista_core(core_taps(sd, torch.float32), x1, z, z, x1, x1, depth=DEPTH, shard=shard)
    for impl in ({"ista_impl": "cuda"}, {"core_impl": "cuda"}, {"core_impl": "plain"}):
        cfg = dataclasses.replace(tcfg, **impl)
        state = tcista.cista_zero_state(cfg, 1, device="cpu", shard=shard)
        with torch.no_grad(), pytest.raises(ValueError, match="the layers core with the plain"):
            tcista.half_res_core(sd, cfg, torch.zeros(1, H // 2, 10, C), state, shard)


def _refuse_fused():
    _, _, tcfg, sd = _weights("cista-lstc")
    cfg = dataclasses.replace(tcfg, fullres_impl="fused")
    shard = spatial.Shard(None, 0, 2)
    seq = torch.zeros(1, 1, H, 20, NB)
    with torch.no_grad(), pytest.raises(ValueError, match="fullres_impl='fused'"):
        tcista.cista_sequence(sd, cfg, seq, shard=shard)
    with torch.no_grad(), pytest.raises(ValueError, match="fullres_impl='fused'"):
        tcista.cista_lstc_step(sd, cfg, seq[0], seq[0, ..., :1],
                               tcista.cista_zero_state(cfg, 1, device="cpu", shard=shard), shard)
    with torch.no_grad(), pytest.raises(ValueError, match="int8 steps"):
        tcista.cista_sequence(sd, dataclasses.replace(tcfg, quant="int8"), seq, shard=shard)


def _refuse_uneven():
    mesh = _sharded_mesh()
    for width in (42, 6, 4):  # 42 / 2 is odd; 6 has no 4 equal blocks; 4 leaves 1 half-res column
        with pytest.raises(ValueError, match="does not divide over the spatial axis"):
            mesh.cols(torch.zeros(1, 2, width, 1), 2)
    assert mesh.cols(np.arange(40).reshape(1, 40), 1).tolist() == [list(range(20, 40))]
    _, _, tcfg, sd = _weights("cista-lstc")
    with pytest.raises(ValueError, match="does not divide over the spatial axis"):
        steps.make_e2v_train_step(dataclasses.replace(tcfg, image_dim=(H, 42)),
                                  steps.make_adam(sd, tcfg, 1e-4), mesh=mesh)
    with pytest.raises(ValueError, match="a sharded sequence holds"):
        tcista.cista_sequence(sd, tcfg, torch.zeros(1, 1, H, 40, NB),
                              shard=spatial.Shard(None, 0, 2))


def _refuse_v2e2v_steps():
    from test_torch_distributed import _inputs

    inp, _ = _inputs()
    vcfg = inp["v2e2v_cfg"]
    sd = tcista.tie_weights({k: v.clone() for k, v in inp["weights"].items()}, vcfg.cista)
    for make in (steps.make_v2e2v_train_step, steps.make_v2e2v_train_step_device_data):
        with pytest.raises(ValueError, match="V2E2V steps shard the data axis only"):
            make(vcfg, steps.make_adam(sd, vcfg.cista, 1e-4), mesh=_sharded_mesh())


def _refuse_pool():
    _, _, tcfg, sd = _weights("cista-lstc")
    with pytest.raises(ValueError, match="no spatial axis"):
        StreamPool(tcfg, sd, 2, torch.float32,
                   mesh=tmesh.Mesh((torch.device("cpu"),) * 2, n_spatial=2))
    with pytest.raises(ValueError, match="needs a process group|shards the width over processes"):
        tmesh.make_mesh(1, 2, devices=["cpu"])


def _refuse_v2e2v_cli():
    with pytest.raises(ValueError, match="no spatial axis either"):
        ttrain.main(["--path_to_train_data", "nowhere", "--mesh_spatial", "2"])


REFUSALS = {"uneven_width": _refuse_uneven, "fused_fullres": _refuse_fused,
            "kernels": _refuse_sharded_kernels, "v2e2v_steps": _refuse_v2e2v_steps,
            "stream_pool": _refuse_pool, "v2e2v_cli": _refuse_v2e2v_cli}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals(what):
    REFUSALS[what]()
