"""Multi-satellite constellation simulation on the PyTorch port's Fleet
(the counterpart of examples/constellation_sim.py): N satellites share one stacked budget ledger and one set of
compiled capture/counting programs; every round each satellite flies a
pass over fresh ground (eclipse/sunlit harvest profile feeding its
energy grant) and rotating ground stations drain one satellite per
window at elevation-dependent bandwidth.

  PYTHONPATH=src python examples/constellation_sim_torch.py --sats 4 --rounds 4
  PYTHONPATH=src python examples/constellation_sim_torch.py --device cpu --check

Contact rounds execute as declarative ContactPlans: each scenario
round's contact events become one lane-stacked plan
(``Round.contact_plan``) that the batched ground-segment core drains —
no per-window host loop. ``--async-ground`` additionally overlaps each
round's batched ground recount with the next round's ingest dispatch;
``--async-depth K`` deepens that overlap into a bounded pipeline that
keeps up to K rounds' recounts in flight (exact at every depth).

``--oracle`` runs the same scenario through the looped sequential
per-Mission path (the parity oracle the fleet is exact-equal to);
``--check`` runs both and asserts exact equality of every satellite's
per-tile predictions. ``--devices N`` splits the fleet along a ``sats``
device mesh of N ranks: with no process group up, the example starts
the N ranks itself (``gloo`` for ``--device cpu``, NCCL and one card a
rank for cuda, from a ``file://`` store in a temporary directory; no
network), hands them the counters it loaded, and prints rank 0's
report; started under a process group of N ranks, each rank runs the
example as it is. ``--check`` then holds the sharded fleet to the looped
Missions:

  PYTHONPATH=src python examples/constellation_sim_torch.py --device cpu --devices 4 --check

``--geometry orbital`` swaps the toy phase-offset scenario for the
orbital geometry engine (:mod:`repro_torch.orbits`): a Walker-delta
constellation is batch-propagated over the horizon, contact windows
come from extracted ground-station passes (elevation-priced bandwidth,
duration-integrated budgets) over a globally dispersed site network
(``--stations N``), and harvest grants come from cylindrical
Earth-shadow eclipse fractions. The fleet/contact tiers are untouched —
``--check`` asserts the same exact parity on the orbital event stream.

``--faults SEED`` turns on deterministic fault injection
(:mod:`repro_torch.core.faults`): dropped windows, station outages,
mid-window truncations, corrupted downlink segments with bounded
retry, and satellite blackouts, all drawn from the seed (rates via
``--drop-rate`` etc.). With ``--check``, the faulty batched fleet is
asserted bit-equal to the faulty scalar FIFO reference instead of the
oracle, and the run's ledgers are asserted non-negative.

Runs on the GPU unless ``--device cpu`` is given; imports nothing of the
JAX package.
"""
import argparse
import contextlib
import io
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.fleet import run_scenario
from repro_torch.core.fleet_sharding import sats_mesh
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.data.scenarios import (FleetScenarioSpec, GroundStation,
                                        generate_scenario)
from repro_torch.data.synthetic import SceneSpec
from repro_torch.launch.serve import get_counters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sats", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4,
                    help="orbital pass rounds (one contact per station each)")
    ap.add_argument("--bandwidth", type=float, default=50.0)
    ap.add_argument("--geometry", choices=("toy", "orbital"), default="toy",
                    help="scenario geometry: 'toy' phase-offset model "
                         "(default) or the batched orbital engine")
    ap.add_argument("--stations", type=int, default=None,
                    help="ground stations (default: 1 toy, 3 orbital)")
    ap.add_argument("--min-elev", type=float, default=5.0,
                    help="orbital pass-extraction elevation mask (deg)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the fleet across this many devices "
                         "(sats mesh axis)")
    ap.add_argument("--oracle", action="store_true",
                    help="run the looped per-Mission parity oracle instead")
    ap.add_argument("--check", action="store_true",
                    help="run BOTH paths and assert exact parity")
    ap.add_argument("--async-ground", action="store_true",
                    help="overlap each round's batched ground recount "
                         "with the next round's ingest (exact either way; "
                         "shorthand for --async-depth 1)")
    ap.add_argument("--async-depth", type=int, default=None, metavar="K",
                    help="bounded ground-recount pipeline depth: keep up "
                         "to K rounds' recounts in flight behind later "
                         "rounds' ingest (0 = synchronous; exact at "
                         "every depth)")
    ap.add_argument("--ingest-overlap", action="store_true",
                    help="round-pipeline ingest itself: defer each "
                         "round's device->host fetches behind the next "
                         "round's dispatch (exact either way)")
    ap.add_argument("--faults", type=int, default=None, metavar="SEED",
                    help="inject a deterministic fault schedule drawn "
                         "from this seed (drops, outages, truncations, "
                         "corruption+retry, blackouts)")
    ap.add_argument("--drop-rate", type=float, default=0.15)
    ap.add_argument("--truncate-rate", type=float, default=0.15)
    ap.add_argument("--corrupt-rate", type=float, default=0.25)
    ap.add_argument("--blackout-rate", type=float, default=0.1)
    ap.add_argument("--outage-rate", type=float, default=0.25)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.faults is not None and args.oracle:
        ap.error("--faults needs the fleet executors (drop --oracle)")
    if (args.devices > 1 and args.device == "cuda"
            and args.devices > torch.cuda.device_count()):
        raise ValueError(f"--devices {args.devices}: only {torch.cuda.device_count()} "
                         f"CUDA device(s) visible")
    import torch.distributed as dist
    space, ground = get_counters(device=args.device)
    if args.devices > 1 and not dist.is_initialized():
        print(_spawn_ranks(args, space, ground), end="")
        return
    simulate(args, space, ground, sats_mesh(args.devices, device_type=args.device))


def _on_cpu(pair):
    params, cfg = pair
    return T.map_leaves(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, params), cfg


def _spawn_ranks(args, space, ground) -> str:
    """Run the example on ``args.devices`` ranks of a process group made
    here -> rank 0's output."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(args, _on_cpu(space), _on_cpu(ground), d,
                              torch.get_num_threads()),
                 nprocs=args.devices, join=True)
        with open(os.path.join(d, "rank0.txt")) as f:
            return f.read()


def _rank(rank, args, space, ground, d, threads):
    """One rank of :func:`_spawn_ranks`: the example on the ``sats`` mesh
    of all the ranks; rank 0 writes its output to ``d``."""
    import torch.distributed as dist
    torch.set_num_threads(threads)
    kw = {}
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("gloo" if args.device == "cpu" else "nccl",
                            init_method=f"file://{d}/store", rank=rank,
                            world_size=args.devices, **kw)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            simulate(args, space, ground, sats_mesh(args.devices, device_type=args.device))
        if rank == 0:
            with open(os.path.join(d, "rank0.txt"), "w") as f:
                f.write(out.getvalue())
    finally:
        dist.destroy_process_group()


def simulate(args, space, ground, mesh=None):
    """The scenario, its runs and the report, on one device or (``mesh``)
    a ``sats`` device mesh."""
    scene_mix = (SceneSpec("track", 512, (16, 28), (10, 24),
                           cloud_fraction=0.3),)
    if args.geometry == "orbital":
        from repro_torch.orbits.schedule import default_sites
        n_st = args.stations or 3
        sites = default_sites(n_st)
        stations = tuple(
            GroundStation(f"gs{k}", bandwidth_mbps=args.bandwidth,
                          site=sites[k]) for k in range(n_st))
        spec = FleetScenarioSpec(
            n_sats=args.sats, n_rounds=args.rounds, frames_per_pass=2,
            stations=stations, scene_mix=scene_mix, seed=7,
            geometry="orbital", min_elev_deg=args.min_elev)
    else:
        stations = tuple(
            GroundStation(f"gs{k}", bandwidth_mbps=args.bandwidth)
            for k in range(args.stations or 1))
        spec = FleetScenarioSpec(
            n_sats=args.sats, n_rounds=args.rounds, frames_per_pass=2,
            stations=stations, scene_mix=scene_mix, seed=7)
    scenario = generate_scenario(spec, device=args.device)
    pcfg = PipelineConfig(method="targetfuse", score_thresh=0.25,
                          bandwidth_mbps=args.bandwidth)
    faults = None
    if args.faults is not None:
        faults = spec.fault_plan(
            args.faults, drop_rate=args.drop_rate,
            truncate_rate=args.truncate_rate,
            corrupt_rate=args.corrupt_rate,
            blackout_rate=args.blackout_rate,
            outage_rate=args.outage_rate, max_retries=args.max_retries)

    path = ("oracle (looped Missions)" if args.oracle else
            f"fleet ({args.devices} device(s))")
    print(f"== {args.sats}-satellite constellation, {args.rounds} rounds, "
          f"{args.geometry} geometry, {path} path ==")
    if args.geometry == "orbital":
        n_windows = sum(len(r.contacts) for r in scenario.rounds)
        print(f"  {len(stations)} sites, min elevation {args.min_elev:.0f} "
              f"deg -> {n_windows} extracted pass windows")
    for rnd in scenario.rounds:
        sunlit = sum(p.sunlit for p in rnd.passes)
        for c in rnd.contacts:
            print(f"  round {rnd.index}: {sunlit}/{args.sats} sats sunlit; "
                  f"{c.station.name} -> sat{c.sat} at "
                  f"{c.bandwidth_mbps:.1f} Mbps "
                  f"({c.budget_bytes / 1e6:.2f} MB window)")

    results, driver = run_scenario(space, ground, pcfg, scenario,
                                   fleet=not args.oracle, mesh=mesh,
                                   async_ground=args.async_ground,
                                   async_depth=args.async_depth,
                                   ingest_overlap=args.ingest_overlap,
                                   faults=faults, device=args.device)
    if args.check:
        if faults is not None:
            # segment-granular faults need the Fleet executors: gate the
            # faulty batched planner against the scalar FIFO reference
            other, _ = run_scenario(space, ground, pcfg, scenario,
                                    faults=faults, contact_reference=True,
                                    device=args.device)
            what_ref = "scalar FIFO reference (faulty)"
        else:
            other, _ = run_scenario(space, ground, pcfg, scenario,
                                    fleet=args.oracle, device=args.device)
            what_ref = "looped Missions"
        for i, (a, b) in enumerate(zip(results, other)):
            np.testing.assert_array_equal(a.per_tile_pred, b.per_tile_pred)
            assert a.summary() == b.summary(), f"sat{i} summary mismatch"
        what = (f"sharded fleet ({args.devices} devices)"
                if mesh is not None else "fleet")
        print(f"parity check: {what} == {what_ref} (exact)")

    for s, r in enumerate(results):
        print(f"  sat{s}: CMAE={r.cmae:.3f} "
              f"proc={r.tiles_processed_space}/{r.tiles_total} "
              f"down={r.tiles_downlinked} "
              f"energy={r.energy_spent_j:.1f}/{r.energy_budget_j:.1f}J "
              f"bytes={r.bytes_downlinked / 1e6:.2f}MB")

    # budget consistency: the energy cap governs onboard counting, so
    # compute spend never overdraws the granted harvest (capture is
    # charged unconditionally — imaging happens even through an eclipse
    # round's zero grant — so it sits outside the cap)
    agg_budget = sum(r.bytes_budget for r in results)
    if args.oracle:
        missions = driver
        agg_pred = sum(r.total_pred for r in results)
        agg_true = sum(r.total_true for r in results)
        agg_bytes = sum(m.bytes_spent for m in missions)
        for m in missions:
            assert m.ledger.e_com <= m.ledger.budget_j + 1e-9, \
                "onboard compute overdraw"
    else:
        fleet = driver
        s = fleet.summary()  # the fleet-aggregate scalars, ready-made
        agg_pred, agg_true, agg_bytes = (s["total_pred"], s["total_true"],
                                         s["bytes_spent"])
        led = fleet.ledger
        assert (led.e_com <= led.budget_j + 1e-9).all(), \
            "onboard compute overdraw"
        if faults is not None:
            # degraded-mode invariants: reconciliation never leaves a
            # lane negative or double-credits a refund
            for f in ("budget_j", "e_down", "bytes_budget", "bytes_spent"):
                assert (getattr(led, f) >= 0.0).all(), \
                    f"ledger lane {f} went negative under faults"
            assert s["fault_bytes_refunded"] <= s["fault_bytes_wasted"], \
                "refunded more than was wasted"
            print(f"faults (seed {args.faults}): "
                  f"{s['fault_windows_dropped']} windows dropped "
                  f"({s['fault_budget_folded'] / 1e6:.2f} MB folded fwd), "
                  f"{s['fault_windows_truncated']} truncated, "
                  f"{s['fault_segments_corrupted']} segments corrupted "
                  f"({s['fault_segments_requeued']} retried, "
                  f"{s['fault_segments_lost']} lost), "
                  f"{s['fault_blackout_passes']} blackout passes; "
                  f"{s['fault_bytes_refunded'] / 1e6:.2f} MB refunded")
        print(f"fleet runtime: {s['n_devices']} device(s), "
              f"dedup_batched={s['dedup_batched']}, "
              f"ingest {s['tiles_per_s']:.0f} tiles/s "
              f"({s['tiles_per_s_per_sat']:.0f}/sat)")
        if s["ingest_overlap"]:
            print(f"ingest pipeline: {s['ingest_rounds_deferred']} rounds "
                  f"deferred, dispatch {s['ingest_dispatch_s']:.2f}s, "
                  f"fetch {s['host_fetch_s']:.2f}s of "
                  f"{s['device_compute_s']:.2f}s in flight "
                  f"({s['ingest_hidden_frac']:.0%} hidden)")
        print(f"ground segment: {s['windows_served']} windows in "
              f"{s['contact_s']:.2f}s ({s['windows_per_s']:.1f} windows/s, "
              f"{s['bytes_downlinked_per_s'] / 1e6:.1f} MB/s downlinked)"
              + (f"; depth-{s['async_depth']} recount pipeline "
                 f"({s['recount_max_in_flight']} rounds in flight peak): "
                 f"{s['recount_s']:.2f}s recounted, "
                 f"{s['recount_hidden_frac']:.0%} hidden behind ingest"
                 if s["async_ground"] else ""))
    assert agg_bytes <= agg_budget + 1e-6, "byte overdraw"
    print(f"constellation aggregate count: pred={agg_pred:.0f} "
          f"true={agg_true:.0f} "
          f"rel err={abs(agg_pred - agg_true) / max(agg_true, 1):.3f}, "
          f"downlink {agg_bytes / 1e6:.1f} MB within "
          f"{agg_budget / 1e6:.1f} MB of windows")


if __name__ == "__main__":
    main()
