"""The port's ``sats`` device mesh on four ``gloo`` ranks on the CPU.

The counterpart of the reference's sharded fleet tests
(tests/test_fleet.py, from test_off_mesh_sharding_is_noop on), which run
on four forced XLA host devices. Here four processes
(``torch.multiprocessing.spawn``, a ``file://`` store: no network) are
started once for the module; each builds the one-dim ``sats`` mesh
(``sats_mesh(4, device_type="cpu")``) and runs, from the same seeds, the
port's Fleet on the mesh and off it, the batched helpers with the mesh's
placement context and without it, and writes what it got to a file. The
parent holds those results to each other and to the JAX package's
unsharded fleet (the session's trained reduced counters, bridged by
``params_from_jax``), one test a check, all with tolerance 0:

- all five policies on a 3-satellite, 3-round scenario: each satellite's
  per-tile predictions, truth and summary, and the ledger lanes, equal to
  the port's one-device fleet and to the reference's fleet (kodan and
  targetfuse take the reference's representatives after their own
  clustering, as tests/test_torch_fleet.py's ``ReplayFleet`` does: the
  two packages may pick other representatives at exact ties);
- an uneven fleet, 6 satellites on 4 ranks: 8 ledger lanes against 6,
  the pad lanes never written, the summaries equal but for the timing
  keys and the device count;
- ``prepare_frames_multi``, ``count_tiles_multi`` (more chunks than ranks,
  and deferred) and ``dedup_multi`` (groups padded with copies of lane 0)
  bit-equal with the mesh context and without; ``device_constant`` on the
  mesh cached and equal to its host array; ``shard`` / ``gather`` of an
  uneven stack zero-padded and given back whole;
- the recount pipeline at depth 1 and 2 and ``ingest_overlap`` on the
  mesh equal to depth 0 on the mesh and to the one-device fleet: the
  workers launch their rank's counting, and the foreground gathers each
  round when it retires it;
- no pipelined Fleet makes a process group, and no collective is issued
  from any thread but the main one (every ``torch.distributed`` call and
  every functional collective DTensor makes is spied on);
- one rank's worker hung inside its launch half for one round: every rank
  abandons that round, it is recovered once on the foreground, the later
  rounds land from their own workers, and every round equals depth 0;
- every rank ends with the same results.

The reference is imported only in the parent, so the ranks import no JAX.
"""
import os
import pickle
import tempfile
import threading

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config, reduced
from repro_torch.models.detector import params_from_jax

WORLD = 4
METHODS = ("space_only", "ground_only", "tiansuan", "kodan", "targetfuse")
CLUSTERING = ("kodan", "targetfuse")
LEDGER = ("budget_j", "e_cap", "e_com", "e_agg", "e_down", "bytes_budget",
          "bytes_requested", "bytes_spent")
# wall-clock fields of Fleet.summary(), and the device count
TIMING = ("ingest_s", "tiles_per_s", "tiles_per_s_per_sat", "contact_s", "windows_per_s",
          "bytes_downlinked_per_s", "recount_s", "recount_wait_s", "recount_hidden_frac",
          "ingest_dispatch_s", "device_compute_s", "host_fetch_s", "ingest_hidden_frac")
SCENE_A = ("trackA", 384, (10, 18), (10, 24), 0.25)
SCENE_B = ("trackB", 256, (6, 12), (10, 20), 0.2)
# the pipeline runs held to depth 0 on the mesh: (name, policy, options)
PIPELINES = (("depth1", "targetfuse", dict(async_depth=1)),
             ("overlap", "targetfuse", dict(ingest_overlap=True)),
             ("depth2_overlap", "ground_only", dict(async_depth=2, ingest_overlap=True)),
             ("depth2", "targetfuse", dict(async_depth=2)))
# the summary keys that name the pipeline's options and count its rounds
PIPELINE_KEYS = ("async_ground", "async_depth", "recount_rounds_deferred",
                 "recount_max_in_flight", "ingest_overlap", "ingest_rounds_deferred")
# the hung-worker run: the rank whose worker blocks in its first round, and
# a watchdog far above a healthy round's recount of these 3 satellites (a
# healthy worker past it would be a second recovery)
HUNG_RANK, HUNG_WATCHDOG_S = 1, 15.0
# the collectives a rank can issue: torch.distributed's own calls, and the
# functional ones (torch.ops._c10d_functional) DTensor's redistributions make
C10D = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "broadcast",
        "broadcast_object_list", "reduce", "reduce_scatter_tensor", "all_to_all_single",
        "gather", "scatter", "barrier", "send", "recv", "isend", "irecv")
FUNCOL = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
          "broadcast", "all_reduce_coalesced", "all_gather_into_tensor_coalesced",
          "reduce_scatter_tensor_coalesced")
HELPERS = ("prepare_frames_multi", "count_tiles_multi", "dedup_multi", "device_constant",
           "shard_gather")


def _spec(mod, scene_cls, n_sats, n_rounds, frames, seed):
    """tests/test_fleet.py's scenarios: two stations, the scene mix, an
    eclipse profile."""
    return mod.FleetScenarioSpec(
        n_sats=n_sats, n_rounds=n_rounds, frames_per_pass=frames,
        stations=(mod.GroundStation("gs0"),
                  mod.GroundStation("gs1", bandwidth_mbps=30.0, contact_s=240.0)),
        scene_mix=tuple(scene_cls(n, px, o, s, cloud_fraction=c)
                        for n, px, o, s, c in (SCENE_A, SCENE_B)),
        eclipse_fraction=0.35, seed=seed)


MAIN = dict(n_sats=3, n_rounds=3, frames=2, seed=11)
UNEVEN = dict(n_sats=6, n_rounds=2, frames=1, seed=13)
# the pipeline runs and their depth-0 runs count the recounts in batches
# of RECOUNT_BATCH rows (64 by default; a counting batch's results do not
# depend on its size), so that a round's recount spans more than one
# batch and the workers gather
RECOUNT_BATCH = 2


def _facts(results, fl):
    """What a run gave, as host values: per satellite, and the fleet's."""
    s = fl.summary()
    return dict(pred=[r.per_tile_pred for r in results], true=[r.per_tile_true for r in results],
                summ=[r.summary() for r in results], n_lanes=fl.ledger.n_lanes,
                fleet={k: v for k, v in s.items() if k not in TIMING},
                ledger={f: np.array(getattr(fl.ledger, f)) for f in LEDGER})


def _same(x, y) -> bool:
    """Deep equality of nested dicts / lists / arrays / tensors / scalars."""
    if isinstance(x, dict):
        return isinstance(y, dict) and x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, torch.Tensor):
        return isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)
    if isinstance(x, np.ndarray):
        return (isinstance(y, np.ndarray) and x.dtype == y.dtype and x.shape == y.shape
                and np.array_equal(x, y))
    return x == y


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _replay_fleet(reps):
    """The port's Fleet whose batched Dedup runs, after which each
    segment takes the reference run's representatives (``reps[sat][k]``
    is the k-th segment's)."""
    from repro_torch.core import fleet

    class ReplayFleet(fleet.Fleet):
        def _dedup_batched(self, sats, segs, defer=False):
            out = super()._dedup_batched(sats, segs, defer)
            for i in sats:
                segs[i].rep_of = reps[i][len(self.missions[i]._segments)].copy()
            return out
    return ReplayFleet


def _drive(fl, sc):
    n = sc.spec.n_sats
    for rnd in sc.rounds:
        fl.ingest(rnd.frames_per_sat(n), rnd.harvest_per_sat(n))
        if rnd.contacts:
            fl.contact_round(plan=rnd.contact_plan(n))
    return fl.finalize()


class _SmallRecounts:
    """The recounts in batches of RECOUNT_BATCH rows, and a count of the
    sharded counting batches launched on a recount worker's thread (the
    pipeline runs must count their rank's chunks there)."""

    def __init__(self):
        from repro_torch.core import contact, fleet_sharding
        self.n, self.cls, self.contact = 0, fleet_sharding.FleetSharding, contact
        self.orig = self.cls.map_lanes, contact.count_tiles_multi

    def __enter__(self):
        map_lanes, count = self.orig

        def counted(sh, *a, **kw):
            if threading.current_thread().name == "ground-recount":
                self.n += 1
            return map_lanes(sh, *a, **kw)
        self.cls.map_lanes = counted
        self.contact.count_tiles_multi = lambda *a, **kw: count(*a, batch=RECOUNT_BATCH, **kw)
        return self

    def __exit__(self, *exc):
        self.cls.map_lanes, self.contact.count_tiles_multi = self.orig


class _Collectives:
    """Every collective issued in the block -> ``calls``: (name, issued
    on the main thread)."""

    def __enter__(self):
        import torch.distributed as dist
        self.calls, self.saved = [], []
        for owner, names in ((dist, C10D), (torch.ops._c10d_functional, FUNCOL)):
            for name in names:
                fn = getattr(owner, name)
                self.saved.append((owner, name, fn))
                setattr(owner, name, self._spy(name, fn))
        return self

    def _spy(self, name, fn):
        def spy(*a, **kw):
            self.calls.append((name, threading.current_thread() is threading.main_thread()))
            return fn(*a, **kw)
        return spy

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


class _HungLaunch:
    """On ``rank``, the first launch half run on a recount worker blocks
    (ignoring its cancel) until the block exits, then gives up; every
    launch half that ran to its end on a worker is counted in ``done``."""

    def __init__(self, rank):
        from repro_torch.core import contact
        self.rank, self.contact, self.launch = rank, contact, contact._recount_launch
        self.release, self.hung, self.done = threading.Event(), 0, 0

    def __enter__(self):
        def launch(work, cancel=None):
            if threading.current_thread().name != "ground-recount":
                return self.launch(work, cancel)
            if self.rank == HUNG_RANK and not self.hung:
                self.hung += 1
                self.release.wait(300)
                return None
            out = self.launch(work, cancel)
            self.done += out is not None
            return out
        self.contact._recount_launch = launch
        return self

    def __exit__(self, *exc):
        self.contact._recount_launch = self.launch
        self.release.set()


def _fleets(job, mesh):
    from repro_torch.core import fleet
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data import scenarios
    from repro_torch.data.synthetic import SceneSpec
    space, ground = job["port"]
    main = scenarios.generate_scenario(_spec(scenarios, SceneSpec, **MAIN))
    out = {}

    def run(method, sc, reps=None, **kw):
        pcfg = PipelineConfig(method=method, score_thresh=0.25)
        cls = fleet.Fleet if reps is None else _replay_fleet(reps)
        fl = cls(space, ground, pcfg, n_sats=sc.spec.n_sats, device="cpu", **kw)
        return _facts(_drive(fl, sc), fl)
    for method in METHODS:
        reps = job["reps"].get(method)
        out["mesh", method] = run(method, main, reps, mesh=mesh)
        out["plain", method] = run(method, main, reps)
    uneven = scenarios.generate_scenario(_spec(scenarios, SceneSpec, **UNEVEN))
    out["mesh", "uneven"] = run("targetfuse", uneven, mesh=mesh)
    out["plain", "uneven"] = run("targetfuse", uneven)
    for method in sorted({method for _, method, _ in PIPELINES}):
        with _SmallRecounts():
            out["mesh", "small", method] = run(method, main, mesh=mesh)
            out["plain", "small", method] = run(method, main)
    with _Collectives() as spied:
        for name, method, kw in PIPELINES:
            with _SmallRecounts() as counts:
                out["mesh", name] = run(method, main, mesh=mesh, **kw)
            out["mesh", name]["worker_batches"] = counts.n
        with _SmallRecounts(), _HungLaunch(mesh.get_coordinate()[0]) as hung:
            out["mesh", "hung"] = run("targetfuse", main, mesh=mesh, async_depth=2,
                                      watchdog_s=HUNG_WATCHDOG_S)
        out["hung_launches"] = (hung.hung, hung.done)
    out["collectives"] = spied.calls
    return out


def _helpers(job, sh):
    """Each batched helper with the mesh context and without -> {helper:
    True, or what differed}."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core import cascade, dedup, engine, xfer
    from repro_torch.data.synthetic import SceneSpec, make_scene, revisit_frames
    space, _ = job["port"]
    (params, cfg) = space
    rng = np.random.default_rng(17)
    out = {}

    def same(name, got, want):
        if name not in out:
            out[name] = True
        if not _same(got, want):
            out[name] = f"{name}: {got!r:.300} != {want!r:.300}"

    scene = lambda spec: make_scene(rng, SceneSpec(*spec[:4], cloud_fraction=spec[4]))
    single, mixed = [], []
    img, b, c = scene(SCENE_A)
    for k in (2, 1, 3, 2, 1):
        single.append(revisit_frames(rng, img, b, c, k))
    img2, b2, c2 = scene(SCENE_B)
    for k in (3, 0, 2):
        mixed.append(revisit_frames(rng, img, b, c, k) + revisit_frames(rng, img2, b2, c2, 2))
    for workloads in (single, mixed):
        for defer in (False, True):
            a, z = (engine.prepare_frames_multi(workloads, 128, cfg.input_size, 64, device="cpu",
                                                defer_stats=defer, sharding=s)
                    for s in (sh, None))
            for p, q in zip(a, z):
                same("prepare_frames_multi", (p.n, p.true, p.tiles_sp[:p.n], p.tiles_gd[:p.n],
                                              p.moments[:p.n], p.roi_std),
                     (q.n, q.true, q.tiles_sp[:q.n], q.tiles_gd[:q.n], q.moments[:q.n],
                      q.roi_std))
    tiles = torch.from_numpy(rng.random((96, cfg.input_size, cfg.input_size, 3)
                                        ).astype(np.float32))
    parts = [(tiles, np.arange(0, 96, 3)), (tiles, np.array([5, 2, 77])),
             (tiles, np.array([], np.int64)), (tiles, np.arange(40))]
    for batch in (8, 64):   # 10 chunks of 8 (padded to 12 on 4 ranks), one of 64
        want = cascade.count_tiles_multi(params, cfg, parts, batch=batch, score_thresh=0.25)
        same("count_tiles_multi", cascade.count_tiles_multi(
            params, cfg, parts, batch=batch, score_thresh=0.25, sharding=sh), want)
        same("count_tiles_multi", cascade.count_tiles_multi(
            params, cfg, parts, batch=batch, score_thresh=0.25, sharding=sh, defer=True)(), want)
    # two shape buckets: 5 lanes (padded to 8) and 2 (padded to 4)
    dparts = ([(torch.from_numpy(rng.random((128, 9)).astype(np.float32)), 8, s, 100 + s)
               for s in range(5)]
              + [(torch.from_numpy(rng.random((256, 9)).astype(np.float32)), 12, s, 200 + s)
                 for s in range(2)])
    for got, want in zip(dedup.dedup_multi(dparts, sharding=sh), dedup.dedup_multi(dparts)):
        same("dedup_multi", tuple(got), tuple(want))
    # a lane stack cached on the mesh (the dedup's lane counts): the same
    # DTensor again, the host array when gathered; off the mesh a tensor
    ns = np.array([128, 7, 64, 1, 9, 256, 3, 40], np.int64)
    on = xfer.device_constant(ns, sharding=sh)
    same("device_constant", (isinstance(on, DTensor), xfer.device_constant(ns, sharding=sh) is on,
                             sh.gather(on, len(ns))), (True, True, torch.from_numpy(ns)))
    off = xfer.device_constant(ns, "cpu")
    same("device_constant", (isinstance(off, DTensor), off), (False, torch.from_numpy(ns)))
    # 6 lanes on 4 ranks: zero-padded to 8, each rank's 2 rows its own
    for arr in (rng.random((6, 3)), torch.from_numpy(rng.random((6, 2, 2)).astype(np.float32))):
        x = sh.shard(arr)
        full = x.full_tensor()
        want = torch.as_tensor(arr)
        same("shard_gather", (tuple(x.shape), tuple(x.to_local().shape), full[6:].abs().sum().item(),
                              sh.gather(x, 6), full[sh.lanes(8)]),
             ((8, *arr.shape[1:]), (2, *arr.shape[1:]), 0.0, want, x.to_local()))
    return out


def _worker(rank, world, path, job):
    import torch.distributed as dist
    from repro_torch.core.fleet_sharding import FleetSharding, sats_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank,
                            world_size=world)
    try:
        mesh = sats_mesh(world, device_type="cpu")
        sh = FleetSharding(mesh)
        out = dict(rank=sh.rank, n_devices=sh.n_devices, helpers=_helpers(job, sh))
        new_group, groups = dist.new_group, []
        dist.new_group = lambda *a, **kw: groups.append(1) or new_group(*a, **kw)
        try:
            out["fleets"] = _fleets(job, mesh)
            out["hung_launches"] = out["fleets"].pop("hung_launches")
        finally:
            dist.new_group = new_group
        out["new_groups"] = len(groups)
        # a mesh over the first two ranks: every rank takes part in making it
        part = sats_mesh(2, device_type="cpu")
        try:
            out["part"] = (FleetSharding(part).n_devices, FleetSharding(part).rank)
        except ValueError as e:
            out["part"] = str(e)
        try:
            sats_mesh(world + 1, device_type="cpu")
        except ValueError as e:
            out["too_many"] = str(e)
        out["one"] = sats_mesh(1, device_type="cpu")
        with open(os.path.join(path, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(counters):
    """The reference's runs (the parent) and the four ranks' -> (ref, [rank
    0's, ..., rank 3's])."""
    from repro.core.fleet import run_scenario as jrun
    from repro.core.pipeline import PipelineConfig as JConfig
    from repro.data import scenarios as jscenarios
    from repro.data.synthetic import SceneSpec as JSceneSpec
    (sp, _), (gd, _) = counters
    port = ((params_from_jax(sp), reduced(get_config("targetfuse-space"))),
            (params_from_jax(gd), reduced(get_config("targetfuse-ground"))))
    jsc = jscenarios.generate_scenario(_spec(jscenarios, JSceneSpec, **MAIN))
    ref, reps = {}, {}
    for method in METHODS:
        results, jf = jrun(*counters, JConfig(method=method, score_thresh=0.25), jsc)
        ref[method] = _facts(results, jf)
        if method in CLUSTERING:
            reps[method] = [[np.asarray(s.rep_of) for s in m._segments] for m in jf.missions]
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_worker, args=(WORLD, d, dict(port=port, reps=reps)), nprocs=WORLD, join=True)
        got = []
        for r in range(WORLD):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                got.append(pickle.load(f))
    return ref, got


def _assert_same_sats(got, want, n, ctx, skip=()):
    for i in range(n):
        np.testing.assert_array_equal(got["pred"][i], want["pred"][i], err_msg=f"{ctx} sat{i}")
        np.testing.assert_array_equal(got["true"][i], want["true"][i], err_msg=f"{ctx} sat{i}")
        assert got["summ"][i] == want["summ"][i], f"{ctx} sat{i}"
    for f in LEDGER:
        np.testing.assert_array_equal(got["ledger"][f][:n], want["ledger"][f][:n],
                                      err_msg=f"{ctx} ledger {f}")
    a = {k: v for k, v in got["fleet"].items() if k not in skip}
    b = {k: v for k, v in want["fleet"].items() if k not in skip}
    assert a == b, ctx


def test_the_ranks_form_a_four_device_sats_mesh(ranks):
    _, got = ranks
    assert [g["rank"] for g in got] == list(range(WORLD))
    assert all(g["n_devices"] == WORLD for g in got)


def test_sats_mesh_over_part_of_the_group(ranks):
    """``sats_mesh(2)`` on four ranks is a mesh of ranks 0 and 1, of which
    ranks 2 and 3 are not part; more ranks than the group has raise; one
    device is no mesh."""
    _, got = ranks
    assert [g["part"] for g in got[:2]] == [(2, 0), (2, 1)]
    assert all("not in the sats mesh" in g["part"] for g in got[2:])
    assert all("5 devices requested" in g["too_many"] and g["one"] is None for g in got)


@pytest.mark.parametrize("method", METHODS)
def test_sharded_fleet_equals_one_device_and_reference(method, ranks):
    """All five policies: the sharded fleet equals the port's one-device
    fleet and the reference's unsharded fleet, satellite by satellite,
    with the ledger lanes equal; 3 satellites take 4 ledger lanes."""
    ref, got = ranks
    mesh, plain = got[0]["fleets"]["mesh", method], got[0]["fleets"]["plain", method]
    assert mesh["fleet"]["n_devices"] == WORLD and plain["fleet"]["n_devices"] == 1
    assert (mesh["n_lanes"], plain["n_lanes"]) == (4, 3)
    _assert_same_sats(mesh, plain, 3, f"{method} mesh vs one device", skip=("n_devices",))
    _assert_same_sats(mesh, ref[method], 3, f"{method} mesh vs reference", skip=("n_devices",))
    assert sum(sum(p) for p in mesh["pred"]) > 0


def test_sharded_fleet_uneven_lane_padding(ranks):
    """6 satellites on 4 ranks: 8 ledger lanes against 6, the pad lanes
    never written, the results and the summaries (but for the timing keys
    and the device count) those of the one-device fleet."""
    _, got = ranks
    mesh, plain = got[0]["fleets"]["mesh", "uneven"], got[0]["fleets"]["plain", "uneven"]
    assert (mesh["n_lanes"], plain["n_lanes"]) == (8, 6)
    for f in LEDGER:
        assert (mesh["ledger"][f][6:] == 0.0).all(), f"pad lanes of {f} were written"
    _assert_same_sats(mesh, plain, 6, "uneven", skip=("n_devices",))
    assert mesh["fleet"]["n_devices"] == WORLD and plain["fleet"]["n_devices"] == 1


@pytest.mark.parametrize("helper", HELPERS)
def test_sharded_helpers_match_unsharded(helper, ranks):
    _, got = ranks
    for g in got:
        assert g["helpers"][helper] is True, g["helpers"][helper]


def test_pipeline_makes_no_group_and_no_collective_off_the_main_thread(ranks):
    """No Fleet on the mesh, pipelined or not, makes a process group, and
    across every pipeline run and the hung-worker run each rank issues its
    collectives (the agreement of the watchdog's branch and the gathers)
    from its main thread only; the spy sees them there."""
    _, got = ranks
    for g in got:
        assert g["new_groups"] == 0, g["new_groups"]
        calls = g["fleets"]["collectives"]
        assert [c for c in calls if not c[1]] == []
        assert {"all_gather_into_tensor", "all_reduce"} <= {name for name, _ in calls}


@pytest.mark.parametrize("name, method, kw", PIPELINES, ids=[p[0] for p in PIPELINES])
def test_mesh_pipeline_equals_depth_zero(name, method, kw, ranks):
    """The recount pipeline and the ingest overlap on the mesh equal depth
    0 on the mesh and the one-device fleet (the options' own summary keys
    and the device count aside)."""
    _, got = ranks
    f = got[0]["fleets"]
    run = f["mesh", name]
    _assert_same_sats(run, f["mesh", "small", method], 3, name, skip=PIPELINE_KEYS)
    _assert_same_sats(run, f["plain", "small", method], 3, f"{name} vs one device",
                      skip=PIPELINE_KEYS + ("n_devices",))
    assert run["fleet"]["async_depth"] == kw.get("async_depth", 0)
    assert run["fleet"]["ingest_overlap"] == kw.get("ingest_overlap", False)
    if kw.get("async_depth"):
        assert run["fleet"]["recount_rounds_deferred"] > 0
    if kw.get("async_depth"):   # the recounts span batches: the workers gathered
        assert run["worker_batches"] > 0


def test_hung_worker_on_one_rank_is_recovered_once(ranks):
    """Rank 1's worker blocks inside its first round's launch half, deaf
    to its cancel: every rank abandons that round (the watchdog's branch
    is agreed), it is recovered once on the foreground, the later rounds
    land from their own workers on every rank (none waits for the hung
    one), and every round equals depth 0."""
    _, got = ranks
    for g in got:
        f = g["fleets"]
        run = f["mesh", "hung"]
        deferred = run["fleet"]["recount_rounds_deferred"]
        assert run["fleet"]["fault_watchdog_recoveries"] == 1
        assert deferred >= 2
        want = (1, deferred - 1) if g["rank"] == HUNG_RANK else (0, deferred)
        assert g["hung_launches"] == want, (g["rank"], g["hung_launches"], want)
        _assert_same_sats(run, f["mesh", "small", "targetfuse"], 3, f"hung rank {g['rank']}",
                          skip=PIPELINE_KEYS + ("fault_watchdog_recoveries",))


def test_every_rank_ends_with_the_same_results(ranks):
    _, got = ranks
    for g in got[1:]:
        assert _same(g["fleets"], got[0]["fleets"])
