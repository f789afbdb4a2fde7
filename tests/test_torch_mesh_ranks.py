"""The port's mesh layer on real ranks: four ``gloo`` processes on the
CPU (``torch.multiprocessing.spawn``, a ``file://`` store: no network)
with a (2, 2) ("data", "model") DeviceMesh.

Each rank builds the same seeded inputs, runs a cell's plain plan on the
whole of them, and the cell's mesh plan (``build_plan(..., mesh)``) on
the same inputs laid out by its ``in_shardings``; the sharded outputs,
gathered (``full_tensor``), must equal the plain ones: the discrete
outputs (counts, assignments, the downlink and space masks) exactly, the
floats within the tolerances stated below (a sharded product adds its
partial sums in another order). The cells: a reduced dense LM's training
step (head-parallel attention, tensor-parallel MLP), a reduced MoE LM's
training step (experts over "model", groups over "data"), and the
onboard serve step of both reduced counters (pure data parallelism, the
throttle on the whole batch). Every kernel entry of ``kernels.ops`` (each
a plain version here) on DTensors, laid out where the op is local and
where it must be redistributed first, equals the entry on the whole
tensors (attention's gradient too). Each rank's shard of a spec is the
one JAX gives the device at its mesh coordinate. ``reshard_state`` round
trips a state from a one-rank mesh to the four ranks and back, and
``build_lm_trainer(cfg, mesh)`` trains as the one-device trainer does
(after two steps each parameter's update within UPDATE_TOL of the plain
trainer's, where both steps' plain gradients are sure).
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

# float32 tolerances of the sharded steps against the plain ones: the
# loss relative to itself; each gradient leaf relative to its own largest
# value; each updated parameter, where the plain gradient is above
# GRAD_FLOOR of its leaf's largest (below it the first AdamW step's
# direction, g / |g|, is float32 noise), in units of the learning rate
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-3
UPDATE_TOL = 1e-3
LR = 1e-4
# the serve step's float outputs (counts, confidences, the space tier's
# count): pure data parallelism runs each tile whole on one rank, so equal
SERVE_TOL = 0.0


def _group(rank, world, path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank, world_size=world)


def _lm_step(arch):
    from repro_torch import tree as T
    from repro_torch.configs import get_config, get_shape, reduced
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import ctx
    from repro_torch.sharding.place import full
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = reduced(get_config(arch))
    shape = dataclasses.replace(get_shape(arch, "train_4k"), global_batch=4, seq_len=16)
    gen = torch.Generator().manual_seed(0)
    params = lm.init(gen, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16), dtype=np.int32))
    labels = torch.roll(tokens, -1, 1)
    clone = lambda t: T.map_leaves(lambda x: x.clone(), t)
    mesh = make_test_mesh(4, model=2, device_type="cpu")
    plan = steps.build_plan(cfg, shape, arch, mesh)
    # the gradient, plain and on the mesh
    loss0, g0, _ = steps.value_and_grad(lambda p: lm.loss_fn(p, cfg, tokens, labels), params)
    placed = steps.place_inputs(plan, clone(params), steps.opt_init(params), tokens, labels,
                                src_data_rank=None)
    with ctx.use_mesh(mesh), implicit_replication():
        loss1, g1, _ = steps.value_and_grad(
            lambda p: lm.loss_fn(p, cfg, placed[2], placed[3]), placed[0])
    assert abs(float(full(loss1)) - float(loss0)) <= LOSS_RTOL * abs(float(loss0))
    for a, b in zip(T.leaves(full(g1)), T.leaves(g0)):
        assert float((a - b).abs().max()) <= GRAD_TOL * max(float(b.abs().max()), 1e-30)
    # one step of the cell, plain and on the mesh
    plain = steps.build_plan(cfg, shape, arch)
    p0, _, l0 = plain.fn(clone(params), steps.opt_init(params), tokens, labels)
    p1, _, l1 = full(plan.fn(*placed))
    assert abs(float(l1) - float(l0)) <= LOSS_RTOL * abs(float(l0)), (float(l1), float(l0))
    worst = 0.0
    for a, b, g in zip(T.leaves(p1), T.leaves(p0), T.leaves(g0)):
        sure = g.abs() > GRAD_FLOOR * g.abs().max()
        worst = max(worst, float(((a - b).abs() * sure).max()) / LR)
    assert worst <= UPDATE_TOL, worst
    return worst


def _serve(arch):
    from repro_torch.configs import get_config, get_shape, reduced
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import detector
    from repro_torch.sharding.place import full
    cfg = reduced(get_config(arch))
    shape = dataclasses.replace(get_shape(arch, "tiles_416_b256"), global_batch=8,
                                img_res=cfg.input_size)
    gen = torch.Generator().manual_seed(0)
    params = detector.init(gen, cfg, device="cpu")
    rng = np.random.default_rng(2)
    ramp = np.linspace(0.05, 1.0, 8, dtype=np.float32)[:, None, None, None]
    tiles = torch.from_numpy(rng.random((8, shape.img_res, shape.img_res, 3),
                                        dtype=np.float32) * ramp)
    cents = torch.from_numpy(rng.random((steps.SERVE_CLUSTERS, 9), dtype=np.float32))
    plain = steps.build_plan(cfg, shape, arch)
    want = plain.fn(params, tiles, cents)
    mesh = make_test_mesh(4, model=2, device_type="cpu")
    plan = steps.build_plan(cfg, shape, arch, mesh)
    got = full(plan.fn(*steps.place_inputs(plan, params, tiles, cents, src_data_rank=None)))
    names = ("counts", "conf", "assign", "downlink", "c_space")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.is_floating_point():
            assert float((a - b).abs().max()) <= SERVE_TOL * max(float(b.abs().max()), 1.0), name
        else:
            assert torch.equal(a, b), name


def _reshard(rank):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from repro_torch.runtime.supervisor import reshard_state
    from repro_torch.sharding import P
    from repro_torch.sharding.place import full
    state = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.arange(8.0)}
    one = DeviceMesh("cpu", [rank], mesh_dim_names=("data",))
    four = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    on_one = reshard_state(state, one, lambda s: {"w": P(None, None), "b": P(None)})
    on_four = reshard_state(on_one, four, lambda s: {"w": P("data", None), "b": P("data")})
    assert on_four["w"].to_local().shape == (2, 8)
    assert torch.equal(on_four["w"].to_local(), state["w"][2 * rank:2 * rank + 2])
    back = full(reshard_state(on_four, one, lambda s: {"w": P(None, None), "b": P(None)}))
    for k in state:
        assert torch.equal(back[k], state[k]), k


# the kernel entries on shards against the plain versions on the whole:
# float outputs within KERNEL_TOL of their largest value (a product over
# fewer rows may block its sums otherwise), discrete ones equal
KERNEL_TOL = 1e-6


def _close(a, b, what):
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if b.is_floating_point():
        err = float((a - b).abs().max()) if b.numel() else 0.0
        assert err <= KERNEL_TOL * max(float(b.abs().max()), 1.0), (what, err)
    else:
        assert torch.equal(a, b), what


def _kernels():
    """Every entry of ``kernels.ops`` on DTensors of a (2, 2) mesh, laid
    out where the op is local and where it must first be redistributed."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(4, model=2, device_type="cpu")
    R = Replicate()
    put = lambda x, *pl: distribute_tensor(x, mesh, list(pl), src_data_rank=None)
    g = torch.Generator().manual_seed(3)
    tiles = torch.rand(8, 12, 12, 3, generator=g)
    want = ops.tile_moments(tiles)
    for pl in ((Shard(0), Shard(0)), (Shard(1), R), (R, Shard(3))):
        _close(ops.tile_moments(put(tiles, *pl)), want, ("tile_moments", pl))
    x, c = torch.rand(16, 9, generator=g), torch.rand(6, 9, generator=g)
    wa, wd = ops.kmeans_assign(x, c)
    for pl in ((Shard(0), Shard(0)), (Shard(1), R)):
        a, d = ops.kmeans_assign(put(x, *pl), put(c, Shard(0), R))
        _close(a, wa, "kmeans_assign"), _close(d, wd, "kmeans_assign d2")
    cs, picks = ops.kmeanspp_seed(x, 16, 3, 5, 8)
    gs, gp = ops.kmeanspp_seed(put(x, Shard(0), R), 16, 3, 5, 8)
    _close(gs, cs, "kmeanspp_seed"), _close(gp, picks, "kmeanspp_seed picks")
    xl, cl = torch.rand(4, 16, 9, generator=g), torch.rand(4, 6, 9, generator=g)
    wa, wd = ops.kmeans_assign_lanes(xl, cl)
    a, d = ops.kmeans_assign_lanes(put(xl, Shard(0), R), put(cl, R, R))
    _close(a, wa, "lanes"), _close(d, wd, "lanes d2")
    n = torch.tensor([16, 12, 9, 16], dtype=torch.int32)
    first = torch.tensor([0, 3, 2, 5], dtype=torch.int32)
    k = torch.tensor([4, 3, 2, 5], dtype=torch.int32)
    ws, wp = ops.kmeanspp_seed_lanes(xl, n, first, k, 8)
    gs, gp = ops.kmeanspp_seed_lanes(put(xl, Shard(0), Shard(0)), n, first, k, 8)
    _close(gs, ws, "seed lanes"), _close(gp, wp, "seed lanes picks")
    boxes = torch.sort(torch.rand(2, 8, 20, 4, generator=g) * 50, dim=-1).values
    boxes = boxes[..., [0, 1, 2, 3]]
    b2 = torch.sort(torch.rand(6, 4, generator=g) * 50, dim=-1).values
    _close(ops.iou_matrix(put(boxes[0], Shard(0), R), put(b2, Shard(0), R)),
           ops.iou_matrix(boxes[0], b2), "iou_matrix")
    _close(ops.iou_matrix(put(boxes, Shard(0), Shard(1)), put(boxes, Shard(0), R)),
           ops.iou_matrix(boxes, boxes), "iou_matrix batched")
    b3 = boxes.reshape(16, 20, 4)
    scores = torch.rand(16, 20, generator=g)
    top_s, top_i = torch.topk(scores, 8, dim=-1)
    want = ops.nms_keep(b3, top_i, top_s, 0.3, 0.2)
    for pl in ((Shard(0), Shard(0)), (Shard(1), R)):
        got = ops.nms_keep(put(b3, *pl), put(top_i, Shard(0), R), put(top_s, R, R), 0.3, 0.2)
        _close(got, want, ("nms_keep", pl))
    q = torch.randn(4, 10, 4, 8, generator=g)
    kv = torch.randn(4, 10, 2, 8, generator=g), torch.randn(4, 10, 2, 8, generator=g)
    for causal in (False, True):
        want = ops.attention(q, *kv, causal=causal)
        for pl in ((Shard(0), Shard(2)), (Shard(0), Shard(0)), (Shard(1), R), (R, Shard(3))):
            got = ops.attention(put(q, *pl), *(put(t, *pl) for t in kv), causal=causal)
            _close(got, want, ("attention", causal, pl))
    # the gradient through the shards' autograd
    leaves = [t.clone().requires_grad_() for t in (q, *kv)]
    torch.autograd.backward(ops.attention(*leaves, causal=True).square().sum())
    dl = [put(t, Shard(0), Shard(2)).detach().requires_grad_() for t in (q, *kv)]
    torch.autograd.backward(ops.attention(*dl, causal=True).square().sum())
    for a, b in zip(dl, leaves):
        _close(a.grad, b.grad, "attention gradient")
    cache = torch.randn(4, 12, 2, 8, generator=g), torch.randn(4, 12, 2, 8, generator=g)
    q1, kv_len = q[:, :1], torch.tensor([3, 12, 7, 1], dtype=torch.int32)
    want = ops.decode_attention(q1, *cache, kv_len=kv_len)
    got = ops.decode_attention(put(q1, Shard(0), R), *(put(t, Shard(0), Shard(1)) for t in cache),
                               kv_len=put(kv_len, Shard(0), R))
    _close(got, want, "decode_attention")
    xq, xs = ops.quantize_int8(torch.randn(8, 32, generator=g))
    wq, ws = ops.quantize_int8(torch.randn(32, 12, generator=g), dim=0)
    want = ops.int8_matmul(xq, wq, xs, ws)
    for xpl, wpl in (((Shard(0), R), (R, Shard(1))), ((Shard(0), Shard(0)), (R, R)),
                     ((R, R), (Shard(1), Shard(0))), ((Shard(1), R), (Shard(0), R))):
        xsp = tuple(Shard(0) if p == Shard(0) else R for p in xpl)
        wsp = tuple(Shard(0) if p == Shard(1) else R for p in wpl)
        got = ops.int8_matmul(put(xq, *xpl), put(wq, *wpl), put(xs, *xsp), put(ws, *wsp))
        _close(got, want, ("int8_matmul", xpl, wpl))


def _layout(rank):
    """Each rank's shard of a tensor laid out by a spec is the shard
    that JAX gives the device at the same mesh coordinate."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import P
    from repro_torch.sharding.place import distribute
    mesh = make_test_mesh(4, model=2, device_type="cpu")
    jmesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    dev = jax.devices()[rank]
    for spec in ((("data", "model"), None, None), ("data", "model", None), (None, "data", None),
                 ("model", None, "data"), (None, None, None)):
        idx = NamedSharding(jmesh, JP(*spec)).devices_indices_map(x.shape)[dev]
        got = distribute(x, P(*spec), mesh, src_data_rank=None).to_local()
        assert torch.equal(got, x[idx]), spec


def _trainer():
    """``launch.train.build_lm_trainer(cfg, mesh)`` under ``run_training``:
    two steps on the state laid out by ``place_state`` equal two plain
    steps: the losses within LOSS_RTOL, and each parameter's update (new
    less initial) within UPDATE_TOL learning rates of the plain trainer's
    wherever the plain gradients of both steps are above GRAD_FLOOR of
    their leaf's largest (elsewhere within two learning rates)."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.sharding.place import full
    cfg = reduced(get_config("qwen3-8b"))
    mesh = make_test_mesh(4, model=2, device_type="cpu")
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32) for _ in range(2)]
    out, sure = [], None
    for m in (None, mesh):
        step_fn, opt_init = train.build_lm_trainer(cfg, m, lr=LR, total_steps=2, device="cpu")
        p = T.map_leaves(lambda x: x.clone(), params)
        if m is not None:
            p = train.place_state(p, cfg, m)
        state, losses = (p, opt_init(p), torch.Generator().get_state()), []
        for tok in batches:
            if m is None:   # where the plain gradient of this step is sure
                tt = torch.from_numpy(tok)
                g = steps.value_and_grad(
                    lambda q: lm.loss_fn(q, cfg, tt, torch.roll(tt, -1, 1)), state[0])[1]
                now = [x.abs() > GRAD_FLOOR * x.abs().max() for x in T.leaves(g)]
                sure = now if sure is None else [a & b for a, b in zip(sure, now)]
            state, loss = step_fn(state, (tok, np.roll(tok, -1, axis=1)))
            losses.append(float(loss))
        out.append((full(state[0]), losses))
    (p0, l0), (p1, l1) = out
    for a, b in zip(l1, l0):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (l1, l0)
    worst, n_sure, n = 0.0, 0, 0
    for a, b, x, ok in zip(T.leaves(p1), T.leaves(p0), T.leaves(params), sure):
        err = ((a - x) - (b - x)).abs()
        worst = max(worst, float((err * ok).max()) / LR)
        assert float(err.max()) <= 2 * LR, float(err.max())
        n_sure, n = n_sure + int(ok.sum()), n + ok.numel()
    assert worst <= UPDATE_TOL, worst
    assert n_sure >= n // 2, (n_sure, n)


def _compress():
    """``optim.compress.int8_roundtrip_tree`` of DTensor leaves (split on
    both mesh dims, on one, replicated, unevenly) equals the plain call on
    the whole values, bit for bit, from generators in the same state,
    which it leaves in the same state; every leaf keeps its layout."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.compress import int8_roundtrip_tree
    mesh = make_test_mesh(4, model=2, device_type="cpu")
    g = torch.Generator().manual_seed(5)
    tree = {"w": torch.randn(8, 12, generator=g), "b": torch.randn(10, generator=g) * 1e-3,
            "e": torch.randn(6, 4, 2, generator=g), "z": torch.zeros(4, 4)}
    layout = {"w": (Shard(0), Shard(1)), "b": (Shard(0), Replicate()),
              "e": (Shard(0), Shard(0)), "z": (Replicate(), Shard(1))}
    placed = {k: distribute_tensor(v, mesh, layout[k], src_data_rank=None)
              for k, v in tree.items()}
    g0, g1 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    want = int8_roundtrip_tree(tree, g0)
    got = int8_roundtrip_tree(placed, g1)
    for k in tree:
        assert tuple(got[k].placements) == layout[k], k
        assert torch.equal(got[k].full_tensor(), want[k]), k
    assert torch.equal(g0.get_state(), g1.get_state())


# the compressed trainers: after two steps each parameter's update (new
# less initial) equals the plain compressed trainer's within UPDATE_TOL
# learning rates except where the stochastic rounding flipped: the
# sharded gradient differs from the plain one in its last bits (GRAD_TOL
# above), and where a uniform falls between the two scaled values the
# element rounds to the neighbouring int8 step, a whole step of
# max|g| / 127, which moves that element's AdamW update by up to 2 lr a
# step. So every element within COMPRESS_FLIP_TOL learning rates, and
# at most COMPRESS_FLIP_SHARE of the elements beyond UPDATE_TOL.
COMPRESS_FLIP_TOL = 4.0
COMPRESS_FLIP_SHARE = 1e-3


def _compress_trainer():
    """``build_lm_trainer(cfg, mesh, compress=True)`` under two steps
    against the plain compressed trainer from the same state: the losses
    within LOSS_RTOL, the updates as stated above."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.sharding.place import full
    cfg = reduced(get_config("qwen3-8b"))
    mesh = make_test_mesh(4, model=2, device_type="cpu")
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32) for _ in range(2)]
    out = []
    for m in (None, mesh):
        step_fn, opt_init = train.build_lm_trainer(cfg, m, lr=LR, total_steps=2, compress=True,
                                                   device="cpu")
        p = T.map_leaves(lambda x: x.clone(), params)
        if m is not None:
            p = train.place_state(p, cfg, m)
        state, losses = (p, opt_init(p), torch.Generator().manual_seed(7).get_state()), []
        for tok in batches:
            state, loss = step_fn(state, (tok, np.roll(tok, -1, axis=1)))
            losses.append(float(loss))
        out.append((full(state[0]), losses, state[2]))
    (p0, l0, r0), (p1, l1, r1) = out
    for a, b in zip(l1, l0):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (l1, l0)
    assert torch.equal(r0, r1)   # the same draws were taken
    worst, beyond, n = 0.0, 0, 0
    for a, b, x in zip(T.leaves(p1), T.leaves(p0), T.leaves(params)):
        err = ((a - x) - (b - x)).abs() / LR
        worst = max(worst, float(err.max()))
        beyond, n = beyond + int((err > UPDATE_TOL).sum()), n + err.numel()
    assert worst <= COMPRESS_FLIP_TOL, worst
    assert beyond <= COMPRESS_FLIP_SHARE * n, (beyond, n)


def _worker(rank, world, path, job):
    import torch.distributed as dist
    _group(rank, world, path)
    try:
        if job == "lm":
            _lm_step("qwen3-8b")
        elif job == "moe":
            _lm_step("qwen2-moe-a2.7b")
        elif job == "serve":
            _serve("targetfuse-space")
            _serve("targetfuse-ground")
        elif job == "reshard":
            _reshard(rank)
        elif job == "kernels":
            _kernels()
        elif job == "layout":
            _layout(rank)
        elif job == "trainer":
            _trainer()
        elif job == "compress":
            _compress()
        elif job == "compress_trainer":
            _compress_trainer()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("job", ["lm", "moe", "serve", "reshard", "kernels", "layout",
                                 "trainer", "compress", "compress_trainer"])
def test_four_gloo_ranks(job):
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_worker, args=(4, os.path.join(d, "store"), job), nprocs=4, join=True)
