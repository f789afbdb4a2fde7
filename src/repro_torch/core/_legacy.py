"""FROZEN pre-refactor ``run_pipeline`` monolith, PyTorch: a parity oracle only.

Counterpart of ``repro/core/_legacy.py``: the ~200-line function with
the five baselines as inline ``pcfg.method`` branches, kept verbatim on
the port's own primitives (``engine.prepare_frames``,
``dedup.dedup_from_moments`` / ``dedup.dedup`` with the port's seed,
``cascade.count_tiles_batched`` / ``count_tiles_batched_ref``,
``throttle``, ``energy``, ``metrics.cmae``), so the Mission stage-graph
executor (:mod:`repro_torch.core.mission`) can be held to it bit for bit
on both the engine and the reference path. The reference path's ROI
statistic is the port Mission's float32 population std.

Do NOT modify the behaviour of this module and do NOT import it from
production code: tests (and the smoke run's oracle phase) only. New
functionality goes in :mod:`repro_torch.core.mission` /
:mod:`repro_torch.core.policies`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

import repro_torch.core.dedup as dd
from repro_torch.core import engine, tiling
from repro_torch.core.cascade import count_tiles_batched, count_tiles_batched_ref
from repro_torch.core.energy import EnergyLedger, detector_gflops, max_tiles_within_budget
from repro_torch.core.metrics import cmae
from repro_torch.core.pipeline import PipelineConfig, PipelineResult
from repro_torch.core.throttle import throttle
from repro_torch.device import resolve_device
from repro_torch.models import detector


def budgets_for_legacy(pcfg: PipelineConfig, n_tiles: int) -> Tuple[float, float, float]:
    day_fraction = n_tiles / pcfg.tiles_per_day
    energy = pcfg.energy_budget_j * day_fraction
    byte_budget = (pcfg.bandwidth_mbps * 1e6 / 8.0 * pcfg.contact_s
                   * pcfg.contacts_per_day * day_fraction)
    tile_bytes = float(pcfg.real_tile_px ** 2 * 3)
    return energy, byte_budget, tile_bytes


def _prep_tiles(img, tile_size, input_size, device):
    t = tiling.tile_image(torch.as_tensor(np.asarray(img), dtype=torch.float32).to(device),
                          tile_size)
    return tiling.resize_tiles(t, input_size).cpu().numpy()


def run_pipeline_legacy(frames, space, ground, pcfg: PipelineConfig,
                        energy_cfgs=None, device="cuda") -> PipelineResult:
    """Verbatim pre-refactor pipeline (see module docstring). ``device``
    is "cuda" (the default; raises without a card) or "cpu"."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import tile_counts

    device = resolve_device(device)
    sp_params, sp_cfg = detector.to_device(space[0], device), space[1]
    gd_params, gd_cfg = detector.to_device(ground[0], device), ground[1]
    if energy_cfgs is None:
        energy_cfgs = (get_config("targetfuse-space"), get_config("targetfuse-ground"))
    gfl_sp = detector_gflops(energy_cfgs[0])

    # ---- stage 0: tile every frame, collect ground truth ----
    if pcfg.use_engine:
        prep = engine.prepare_frames(frames, pcfg.tile_size,
                                     sp_cfg.input_size, gd_cfg.input_size,
                                     device=device)
        tiles_sp, tiles_gd, true, n = prep.tiles_sp, prep.tiles_gd, prep.true, prep.n
    else:
        prep = None
        all_tiles_sp, all_tiles_gd, all_true = [], [], []
        for img, boxes, _classes in frames:
            s = img.shape[0]
            all_true.append(tile_counts(boxes, s, pcfg.tile_size))
            all_tiles_sp.append(_prep_tiles(img, pcfg.tile_size, sp_cfg.input_size, device))
            all_tiles_gd.append(_prep_tiles(img, pcfg.tile_size, gd_cfg.input_size, device))
        tiles_sp = np.concatenate(all_tiles_sp)
        tiles_gd = np.concatenate(all_tiles_gd)
        true = np.concatenate(all_true).astype(np.float64)
        n = tiles_sp.shape[0]

    def count_sel(params, cfg, tiles, sel):
        if pcfg.use_engine:
            return count_tiles_batched(params, cfg, tiles, idx=sel,
                                       score_thresh=pcfg.score_thresh)
        return count_tiles_batched_ref(params, cfg, tiles[sel],
                                       score_thresh=pcfg.score_thresh)

    energy_j, budget_bytes, tile_bytes = budgets_for_legacy(pcfg, n)
    ledger = EnergyLedger(budget_j=energy_j)
    ledger.charge_capture(len(frames))

    pred = np.zeros(n, np.float64)
    bytes_down = 0.0

    # ---- ground_only: bent-pipe ----
    if pcfg.method == "ground_only":
        k = int(budget_bytes // tile_bytes)
        sel = np.arange(min(k, n))
        if len(sel):
            c, _ = count_sel(gd_params, gd_cfg, tiles_gd, sel)
            pred[sel] = c
        bytes_down = len(sel) * tile_bytes
        ledger.charge_downlink(bytes_down, pcfg.bandwidth_mbps)
        return _result(pred, true, bytes_down, budget_bytes, 0, len(sel), n, ledger)

    # ---- ROI filter (low-variance tiles are background/cloud) ----
    active = np.ones(n, bool)
    if pcfg.use_roi and pcfg.method in ("kodan", "targetfuse"):
        if prep is not None:
            raw_sd = prep.roi_std
        else:
            # float32 population std over H and W, then the channel mean
            t = torch.from_numpy(tiles_sp).to(device)
            centered = t - t.mean((1, 2), keepdim=True)
            raw_sd = (centered.square().sum((1, 2)) / (t.shape[1] * t.shape[2])).sqrt()
            raw_sd = raw_sd.mean(-1).cpu().numpy()
        active &= raw_sd > pcfg.roi_std_thresh

    # ---- dedup ----
    rep_of = np.arange(n)
    if pcfg.use_dedup and pcfg.method in ("kodan", "targetfuse") and active.sum() > 4:
        k = pcfg.k_clusters or max(2, int(active.sum()) // 2)
        idx_active = np.where(active)[0]
        if prep is not None:
            n_act = len(idx_active)
            idx_pad = np.zeros(dd.dedup_pad_size(n_act), np.int64)
            idx_pad[:n_act] = idx_active
            res = dd.dedup_from_moments(
                prep.moments.index_select(0, torch.from_numpy(idx_pad).to(device)),
                k, pcfg.seed, n=n_act)
        else:
            res = dd.dedup(torch.from_numpy(tiles_sp[idx_active]).to(device), k, pcfg.seed)
        assign = res.assign.cpu().numpy()
        rep_local = res.rep_idx.cpu().numpy()
        rep_of[idx_active] = idx_active[rep_local[assign]]
        ledger.charge_aggregate(len(idx_active))

    reps = np.unique(rep_of[active])

    # ---- energy-capped onboard counting ----
    cap = max_tiles_within_budget(ledger.remaining * 0.95, gfl_sp, pcfg.hardware)
    process = reps[:cap] if len(reps) > cap else reps
    n_processed = len(process)
    ledger.charge_compute(n_processed, gfl_sp, pcfg.hardware)

    counts_sp = np.zeros(n)
    conf = np.full(n, -1.0)
    if n_processed:
        c, f = count_sel(sp_params, sp_cfg, tiles_sp, process)
        counts_sp[process] = c
        conf[process] = f
    counts_sp = counts_sp[rep_of]
    conf = conf[rep_of]
    processed_mask = np.isin(rep_of, process) & active

    # ---- selection + throttling ----
    if pcfg.method == "space_only":
        pred[processed_mask] = counts_sp[processed_mask]
        return _result(pred, true, 0.0, budget_bytes, n_processed, 0, n, ledger)

    if pcfg.method == "tiansuan":
        accept = processed_mask & (conf > pcfg.tiansuan_thresh)
        pred[accept] = counts_sp[accept]
        cand = np.where(active & ~accept)[0]
        cand_reps = np.unique(rep_of[cand])
        k = int(budget_bytes // tile_bytes)
        sel_reps = cand_reps[:k]
        if len(sel_reps):
            c, _ = count_sel(gd_params, gd_cfg, tiles_gd, sel_reps)
            counts_gd = np.zeros(n)
            counts_gd[sel_reps] = c
            got = np.isin(rep_of, sel_reps) & processed_mask & ~accept
            pred[got] = counts_gd[rep_of][got]
        bytes_down = len(sel_reps) * tile_bytes
        ledger.charge_downlink(bytes_down, pcfg.bandwidth_mbps)
        return _result(pred, true, bytes_down, budget_bytes, n_processed,
                       len(sel_reps), n, ledger)

    # kodan / targetfuse: two-threshold selection over representatives
    rep_mask = processed_mask & (rep_of == np.arange(n))
    rep_idx = np.where(rep_mask)[0]
    kodan = pcfg.method == "kodan"
    budget = np.float64(1e18) if kodan else np.float64(budget_bytes)
    n_rep = len(rep_idx)
    if pcfg.use_engine:
        n_pad = dd.bucket_size(max(n_rep, 1))
        conf_pad = np.full(n_pad, -1.0)
        conf_pad[:n_rep] = conf[rep_idx]
        act = np.zeros(n_pad, bool)
        act[:n_rep] = True
        tr = throttle(conf_pad, np.full(n_pad, tile_bytes),
                      budget, pcfg.conf_p, pcfg.conf_q, pcfg.policy,
                      active=act)
        space_m = tr.space.numpy()[:n_rep]
        down_m = tr.downlink.numpy()[:n_rep]
    else:
        tr = throttle(conf[rep_idx], np.full(n_rep, tile_bytes),
                      budget, pcfg.conf_p, pcfg.conf_q, pcfg.policy)
        space_m = tr.space.numpy()
        down_m = tr.downlink.numpy()
    down_reps = rep_idx[down_m]

    unproc_reps = np.where(active & (rep_of == np.arange(n))
                           & ~processed_mask)[0]
    bytes_down = len(down_reps) * tile_bytes
    k_extra = int(max(budget - bytes_down, 0.0) // tile_bytes)
    extra_reps = unproc_reps[:k_extra]
    down_all = np.concatenate([down_reps, extra_reps]).astype(np.int64)

    counts_gd = np.zeros(n)
    if len(down_all):
        c, _ = count_sel(gd_params, gd_cfg, tiles_gd, down_all)
        counts_gd[down_all] = c
    counts_gd = counts_gd[rep_of]

    rep_space = np.zeros(n, bool)
    rep_space[rep_idx[space_m]] = True
    rep_down = np.zeros(n, bool)
    rep_down[down_all] = True
    use_ground = rep_down[rep_of] & active
    use_space = rep_space[rep_of] & processed_mask & ~use_ground
    pred[use_space] = counts_sp[use_space]
    pred[use_ground] = counts_gd[use_ground]

    bytes_down = len(down_all) * tile_bytes
    ledger.charge_downlink(min(bytes_down, budget_bytes), pcfg.bandwidth_mbps)
    return _result(pred, true, bytes_down, budget_bytes, n_processed,
                   len(down_all), n, ledger)


def _result(pred, true, bytes_down, budget_bytes, n_proc, n_down, n,
            ledger) -> PipelineResult:
    return PipelineResult(
        cmae=cmae(pred, true),
        total_true=float(true.sum()),
        total_pred=float(pred.sum()),
        bytes_downlinked=float(bytes_down),
        bytes_budget=float(budget_bytes),
        tiles_processed_space=int(n_proc),
        tiles_downlinked=int(n_down),
        tiles_total=int(n),
        energy_spent_j=float(ledger.spent),
        energy_budget_j=float(ledger.budget_j),
        per_tile_pred=pred,
        per_tile_true=true,
    )
