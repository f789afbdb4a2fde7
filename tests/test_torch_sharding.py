"""The port's sharding layer (``repro_torch.sharding``: the rules, the
policies, ``ctx``; the cells' shardings of ``launch.steps.build_cell``)
against the reference's ``repro.sharding`` and ``repro.launch.steps``,
on the CPU.

A spec is compared entry by entry (``tuple(spec)``: an axis name, a tuple
of names or None a tensor dim). The rules and policies read only the
mesh's names and sizes: the reference's on its (1, 1) ``jax.make_mesh``
and on stand-ins (an object with ``axis_names`` and ``devices.shape``),
the port's on an ``AbstractMesh``, for (1, 1), (2, 4), (2, 2, 2), (16,
16) and (2, 16, 16). ``param_specs`` of every arch of ``ASSIGNED_ARCHS``
and of both counters equals the reference's leaf by leaf, path by path;
every policy function on a grid of batch and sequence sizes. The cells
(all of ``all_cells()`` and the counters' ``DETECTOR_SHAPES``), with each
mesh option where it applies (``zero1_axis``, ``no_pure_dp``,
``dp_serve``): the in and out spec trees equal the reference's
``plan.in_shardings[i].spec`` on (1, 1) in this process, and on ``tiny``
(2, 4) and ``tinymulti`` (2, 2, 2) in one subprocess (this file run as a
script: 8 XLA host devices set before jax is imported, a ``fake`` group
of 8 ranks for the port), where each cell's per-device argument bytes
must also equal the sum of the reference's ``NamedSharding.shard_shape``
bytes, and DTensor's local shape of each leaf on rank 0 the shard shape.
The one difference allowed: a diffusion ``train`` cell's key (P(None)),
which the port takes as ``t`` (laid out as the class ids) and ``noise``
(as the latents).
"""
import functools
import json
import math
import os
import subprocess
import sys
import types

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.sharding import policy as jpol
from repro.sharding import rules as jrules
from repro_torch import tree as T
from repro_torch.configs import DETECTOR_SHAPES, all_cells, get_config, get_shape
from repro_torch.launch import steps
from repro_torch.sharding import AbstractMesh, P, ctx, placements
from repro_torch.sharding import policy as pol
from repro_torch.sharding import rules

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
COUNTERS = ("targetfuse-space", "targetfuse-ground")
CELLS = all_cells() + [(a, s.name) for a in COUNTERS for s in DETECTOR_SHAPES]
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    """(the reference's mesh: its (1, 1) ``jax.make_mesh`` or a stand-in,
    the port's AbstractMesh) of a mesh."""
    shape, names = MESHES[name]
    if shape == (1, 1):
        return jax.make_mesh(shape, names), AbstractMesh(shape, names)
    stand_in = types.SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=object))
    return stand_in, AbstractMesh(shape, names)


def _t(spec):
    return None if spec is None else tuple(spec)


def _options(arch, shape_name):
    """The mesh options that change this cell's layout, each alone."""
    cfg = get_config(arch)
    kind = get_shape(arch, shape_name).kind
    opts = [{}]
    if kind in ("train", "cls"):
        opts.append({"zero1_axis": "data"})
        if cfg.family in ("vision", "diffusion"):
            opts.append({"no_pure_dp": True})
    if cfg.family == "detector" and kind == "serve":
        opts.append({"dp_serve": False})
    return opts


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(reference's parameter shapes, port's meta parameters) of an arch."""
    from repro.models import convnext, detector, dit, lm, resnet, unet, vit
    from repro_torch.models import convnext as tc, detector as td, dit as tdi, lm as tl
    from repro_torch.models import resnet as tr, unet as tu, vit as tv
    cfg = jget_config(arch)
    mods = {"lm": (lm, tl), "dit": (dit, tdi), "unet": (unet, tu), "vit": (vit, tv),
            "convnext": (convnext, tc), "resnet": (resnet, tr), "detector": (detector, td)}
    key = cfg.family if cfg.family in ("lm", "detector") else cfg.kind
    jmod, tmod = mods[key]
    jp = jax.eval_shape(functools.partial(jmod.init, cfg=cfg), jax.random.PRNGKey(0))
    tp = steps._shapes(tmod, get_config(arch))
    if key == "resnet":
        jp, tp = jp[0], tp[0]
    return jp, tp


def _jpath(path):
    return jrules._path_str(path)


_SHAPES = {}


def _memo_eval_shape(eval_shape):
    """``jax.eval_shape`` remembering the parameter trees of the
    reference's inits (``functools.partial(mod.init, cfg=cfg)`` at a key):
    the same init of the same config gives the same shapes, and the
    reference's ``build_cell`` traces it again for every option and mesh."""
    def run(fn, *args, **kwargs):
        if not (isinstance(fn, functools.partial) and fn.func.__name__ == "init"
                and not kwargs):
            return eval_shape(fn, *args)
        key = (fn.func, tuple(sorted(fn.keywords.items())))
        if key not in _SHAPES:
            _SHAPES[key] = eval_shape(fn, *args)
        return _SHAPES[key]
    return run


@pytest.fixture(autouse=True)
def _cached_inits(monkeypatch):
    monkeypatch.setattr(jax, "eval_shape", _memo_eval_shape(jax.eval_shape))


def test_spec_for_path_rank_alignment():
    for pat, spec, path, nd in [(r"wq$", P(None, None, "model"), "blocks/attn/wq", 3),
                                (r"wq$", P(None, None, "model"), "attn/wq", 2),
                                (r"wq$", P(None, None, "model"), "attn/wq", 4),
                                (r"wq$", P(None, None, "model"), "other", 2)]:
        got = rules.spec_for_path(path, nd, [(pat, spec)])
        want = jrules.spec_for_path(path, nd, [(pat, JP(*spec))])
        assert _t(got) == _t(want), (path, nd)
    assert rules.spec_for_path("attn/wq", 2, [(r"wq$", P(None, None, "model"))]) == \
        P(None, "model")


def test_rule_tables_equal_the_reference():
    for name in ("LM_RULES", "VIT_RULES", "CONVNEXT_RULES", "RESNET_RULES", "DIT_RULES",
                 "UNET_RULES", "DETECTOR_RULES"):
        got = [(p, _t(s)) for p, s in getattr(rules, name)]
        want = [(p, _t(s)) for p, s in getattr(jrules, name)]
        assert got == want, name


@pytest.mark.parametrize("mesh", [None] + list(MESHES))
@pytest.mark.parametrize("arch", list(ASSIGNED_ARCHS) + list(COUNTERS))
def test_param_specs_equal_the_reference(arch, mesh):
    jp, tp = _params(arch)
    jm, tm = _meshes(mesh) if mesh else (None, None)
    want = jax.tree_util.tree_flatten_with_path(
        jrules.param_specs(jp, jget_config(arch), jm), is_leaf=lambda x: isinstance(x, JP))[0]
    paths, got = T.flatten_with_paths(rules.param_specs(tp, get_config(arch), tm))
    assert paths == [_jpath(p) for p, _ in want]
    assert [_t(s) for s in got] == [_t(s) for _, s in want]
    if mesh is None:   # most weight bytes sharded, as the reference's test asks
        leaves = T.leaves(tp)
        nbytes = [x.numel() * x.element_size() for x in leaves]
        sharded = sum(b for b, s in zip(nbytes, got) if any(a is not None for a in s))
        assert arch in COUNTERS or sharded / sum(nbytes) > 0.8


BATCHES = (1, 2, 3, 4, 6, 8, 16, 32, 128, 256, 512)
SEQS = (1, 7, 64, 4096, 32768, 524288)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_policies_equal_the_reference(mesh):
    jm, tm = _meshes(mesh)
    lm_cfgs = [(jget_config(a), get_config(a)) for a in ("qwen3-8b", "deepseek-v2-lite-16b")]
    for b in BATCHES:
        assert pol.batch_axes(tm, b) == jpol.batch_axes(jm, b)
        ba = pol.batch_axes(tm, b)
        assert pol.free_data_axis(tm, ba) == jpol.free_data_axis(jm, ba)
        assert _t(pol.image_specs(tm, b)) == _t(jpol.image_specs(jm, b))
        assert _t(pol.token_image_specs(tm, b)) == _t(jpol.token_image_specs(jm, b))
        for s in SEQS:
            for kind in ("train", "prefill", "decode"):
                got = {k: _t(v) for k, v in pol.lm_specs(tm, kind, b, s).items()}
                assert got == {k: _t(v) for k, v in jpol.lm_specs(jm, kind, b, s).items()}
            la = pol.cache_len_axes(tm, b, s)
            assert la == jpol.cache_len_axes(jm, b, s), (b, s)
            for jc, tc in lm_cfgs:
                got = {k: _t(v) for k, v in pol.lm_cache_spec(tm, tc, b, la).items()}
                want = {k: _t(v) for k, v in jpol.lm_cache_spec(jm, jc, b, la).items()}
                assert got == want, (b, s)


def _spec_trees(plan):
    return ([[_t(s.spec) for s in T.leaves(a)] for a in plan.in_shardings],
            [_t(s.spec) for s in T.leaves(plan.out_shardings)])


def _jspec_trees(plan):
    leaf = lambda x: isinstance(x, jax.sharding.NamedSharding)
    return ([[_t(s.spec) for s in jax.tree_util.tree_leaves(a, is_leaf=leaf)]
             for a in plan.in_shardings],
            [_t(s.spec) for s in jax.tree_util.tree_leaves(plan.out_shardings, is_leaf=leaf)])


def compare_cell(arch, shape_name, jmesh, tmesh, opts):
    """-> a list of mismatches of one cell's spec trees (and, on a
    device mesh, of its per-device argument bytes and rank 0's local
    shapes) against the reference's."""
    from repro_torch.launch.dryrun import argument_bytes
    jp = jsteps.build_cell(arch, shape_name, jmesh, **opts)
    tp = steps.build_cell(arch, shape_name, tmesh, **opts)
    (jin, jout), (tin, tout) = _jspec_trees(jp), _spec_trees(tp)
    bad = []
    key = get_config(arch).family == "diffusion" and tp.meta["kind"] == "train"
    if key:   # the reference's key is the port's t and noise
        assert jin[4] == [(None,)]
        ok = tin[:4] == jin[:4] and tin[4] == [_t(P(tin[2][0][0]))] and tin[5] == tin[2]
    else:
        ok = tin == jin
    if not ok or tout != jout:
        bad.append(f"{arch} {shape_name} {opts}: specs differ")
    if hasattr(jmesh, "devices") and not isinstance(jmesh, types.SimpleNamespace):
        leaf = lambda x: isinstance(x, jax.sharding.NamedSharding)
        n = len(jp.args_sds) - (1 if key else 0)
        jbytes = 0
        for a, sh in zip(jp.args_sds[:n], jp.in_shardings[:n]):
            for x, s in zip(jax.tree_util.tree_leaves(a),
                            jax.tree_util.tree_leaves(sh, is_leaf=leaf)):
                jbytes += math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
        tbytes = argument_bytes(tp)
        if key:   # less the port's t and noise
            for x, s in zip((tp.args[4], tp.args[5]), tp.in_shardings[4:]):
                tbytes -= math.prod(s.shard_shape(x.shape)) * x.element_size()
        if jbytes != tbytes:
            bad.append(f"{arch} {shape_name} {opts}: argument bytes {tbytes} != {jbytes}")
        if hasattr(tmesh, "get_coordinate"):
            from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
            for a, sh in zip(tp.args, tp.in_shardings):
                for x, s in zip(T.leaves(a), T.leaves(sh)):
                    local = compute_local_shape_and_global_offset(x.shape, tmesh, s.placements)[0]
                    if tuple(local) != s.shard_shape(x.shape):
                        bad.append(f"{arch} {shape_name}: rank 0 holds {tuple(local)}")
    return bad


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_shardings_equal_the_reference_on_1x1(cell):
    arch, shape_name = cell
    jm = jax.make_mesh((1, 1), ("data", "model"))
    tm = AbstractMesh((1, 1), ("data", "model"))
    bad = []
    for opts in _options(arch, shape_name):
        bad += compare_cell(arch, shape_name, jm, tm, opts)
    assert not bad, bad


def test_mesh_options_need_a_mesh_and_leave_plans_alone():
    for opt in ("zero1_axis", "no_pure_dp", "dp_serve"):
        with pytest.raises(TypeError, match="mesh option"):
            steps.build_cell("vit-l16", "cls_224", **{opt: True})
    plain = steps.build_cell("vit-l16", "cls_224")
    assert plain.mesh is None and plain.in_shardings is None and plain.out_shardings is None
    on = steps.build_cell("vit-l16", "cls_224", AbstractMesh((1, 1), ("data", "model")))
    assert len(on.in_shardings) == len(on.args)
    with pytest.raises(ValueError, match="no mesh"):
        steps.place_inputs(plain, *plain.args)


def test_spec_normalization_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    assert _t(P(("data",), None)) == _t(JP(("data",), None)) == ("data", None)
    assert _t(P((), None)) == _t(JP((), None)) == (None, None)
    assert _t(P(["pod", "data"])) == _t(JP(["pod", "data"])) == (("pod", "data"),)
    m = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, None), m) == (Replicate(),) * 3
    for bad in (P(("data", "pod")), P("data", "data"), P("rows")):
        with pytest.raises(ValueError):
            placements(bad, m)


def test_constrain_is_a_no_op_off_the_mesh():
    x = torch.arange(8.0).reshape(2, 4)
    assert ctx.constrain(x, "data", None) is x
    assert ctx.axis_size("model") is None
    with ctx.use_mesh(AbstractMesh((2, 4), ("data", "model"))):
        assert ctx.axis_size("model") == 4 and ctx.axis_size("pod") is None
        assert ctx.constrain(x, "data", None) is x   # a plain tensor stays as it is
    assert ctx.constrain_spec((4, 6), (("pod", "data"), "model"),
                              AbstractMesh((2, 4), ("data", "model"))) == P("data", None)


def _subprocess_main(mesh_names):
    from repro_torch.launch.dryrun import MESHES as TM, mesh_for
    jax.eval_shape = _memo_eval_shape(jax.eval_shape)
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    bad, n = [], 0
    mesh_for("tiny")   # a fake group of 8 ranks: the production meshes refuse it
    for multi in (False, True):
        try:
            make_production_mesh(multi_pod=multi, device_type="cpu")
            bad.append(f"a production mesh (multi_pod={multi}) on 8 ranks")
        except ValueError:
            pass
    if make_test_mesh(device_type="cpu").shape != (4, 2):
        bad.append("make_test_mesh on 8 ranks is not (4, 2)")
    for name in mesh_names:
        tmesh = mesh_for(name)
        jmesh = jax.make_mesh(*TM[name])
        for arch, shape_name in CELLS:
            for opts in _options(arch, shape_name):
                bad += compare_cell(arch, shape_name, jmesh, tmesh, opts)
                n += 1
    print(json.dumps({"compared": n, "bad": bad}))
    return 1 if bad else 0


def test_cell_shardings_equal_the_reference_on_tiny_meshes():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, __file__, "tiny", "tinymulti"], capture_output=True,
                       text=True, env=env, timeout=600, cwd=os.path.dirname(__file__))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["compared"] >= 2 * len(CELLS) and not out["bad"]


if __name__ == "__main__":
    raise SystemExit(_subprocess_main(sys.argv[1:]))
