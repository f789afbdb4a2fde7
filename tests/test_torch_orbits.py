"""The port's orbital geometry engine against the reference, on the CPU.

Seeded catalogs and time grids (numpy) go through ``repro.orbits`` and
``repro_torch.orbits``:

* Positions (``propagate``, ``eci_to_ecef``), the sun direction and the
  eclipse mask are equal bit for bit. The reference's XLA CPU program
  fuses some products and sums into fused multiply-adds and calls
  glibc's ``sinf``/``cosf``; the port does the same arithmetic
  (``repro_torch/orbits/propagation.py``).
* The elevation grid cannot be: XLA computes ``x / norm(d)`` as ``x *
  rsqrt(|d|^2)`` with the CPU's approximate reciprocal square root and a
  Newton step, and ``arcsin`` through ``atan2``; the port takes the
  exact quotient and arcsine in float64. Their sines of the elevation
  agree to ``SIN_TOL`` (8 float32 ulps of 1: the Newton step leaves
  about 2 ulps, the float32 dot product and norm about 3, the arcsine
  and the degree scaling one each). An elevation error ``e`` in the
  sine is at most ``e / cos(el)`` radians, so a sample can fall on the
  other side of ``min_elev_deg`` only where the reference's elevation is
  within ``_edge_deg(min_elev_deg)`` of it. The pass tests count those samples, print
  them, and require equal passes on every (station, satellite) row
  without one; at these seeds there are none, so every pass is equal.
* Pass extraction and eclipse fractions are host numpy, equal on equal
  inputs. A pass's bandwidth is ``sin(max elevation)`` times the
  station's, so its budget moves by the same relative error as that
  sine, at most ``SIN_TOL / sin(min_elev_deg)``: ``BUDGET_RTOL``.
* A fleet fed the reference's own orbital scenario gives the
  reference's fleet results, satellite by satellite.
"""
import numpy as np
import pytest
import torch

from repro.core.fleet import run_scenario as jrun_scenario
from repro.core.pipeline import PipelineConfig as JConfig
from repro.data import scenarios as jscenarios
from repro.data.synthetic import SceneSpec as JSceneSpec
from repro.orbits import elements as jel
from repro.orbits import propagation as jprop
from repro.orbits import schedule as jsched
from repro.orbits import visibility as jvis
from repro_torch.configs import get_config, reduced
from repro_torch.core import fleet
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.data import scenarios
from repro_torch.data.synthetic import SceneSpec
from repro_torch.models.detector import params_from_jax
from repro_torch.orbits import elements, propagation, schedule, visibility

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SIN_TOL = 8 * 2.0 ** -24
MIN_ELEV = 5.0  # fleet_bench's orbital cell
BUDGET_RTOL = SIN_TOL / np.sin(np.radians(MIN_ELEV))
LEDGER = ("budget_j", "e_cap", "e_com", "e_agg", "e_down", "bytes_budget",
          "bytes_requested", "bytes_spent")
SEEDS = (0, 1, 2)


def _catalog(seed):
    """A seeded scattered shell and a Walker shell, in both packages."""
    rng = np.random.default_rng(seed)
    alt, inc = float(rng.uniform(400, 1200)), float(rng.uniform(0, 98))
    cats = [jel.shell(48, inc, alt, seed=seed, ecc_max=0.02),
            jel.walker_delta(16, 4, inc, alt, phasing=1)]
    return [(c, elements.OrbitalElements(*c.arrays())) for c in cats]


def _grid(seed):
    return np.arange(720, dtype=np.float64) * (30.0 + 15.0 * seed)


def _sites(n):
    return np.stack([jvis.station_ecef(*s) for s in jsched.default_sites(n)])


def _edge_deg(min_elev):
    """How far from the mask an elevation may cross it: SIN_TOL of sine."""
    return float(np.degrees(SIN_TOL / np.cos(np.radians(min_elev))))


def _near_edge(ref_elev, min_elev):
    """(row, sample) of reference elevations within _edge_deg of the mask."""
    rows = np.asarray(ref_elev).reshape(-1, ref_elev.shape[-1])
    return np.argwhere(np.abs(rows - min_elev) < _edge_deg(min_elev))


def _same_passes(got, want, ref_elev, min_elev, ctx):
    """Equal passes on every row with no reference sample at the edge."""
    near = _near_edge(ref_elev, min_elev)
    print(f"{ctx}: {len(near)} reference samples within {_edge_deg(min_elev):.2e} deg "
          f"of {min_elev} deg: {near.tolist()}")
    skip = {int(r) for r, _ in near}
    keep_g = [i for i in range(got.n_passes) if int(got.row[i]) not in skip]
    keep_w = [i for i in range(want.n_passes) if int(want.row[i]) not in skip]
    assert len(keep_g) == len(keep_w), ctx
    for f in ("row", "start", "stop", "t_rise", "t_set", "duration_s", "t_culminate"):
        np.testing.assert_array_equal(getattr(got, f)[keep_g], getattr(want, f)[keep_w],
                                      err_msg=f"{ctx} {f}")
    np.testing.assert_allclose(np.sin(np.radians(got.max_elev_deg[keep_g])),
                               np.sin(np.radians(want.max_elev_deg[keep_w])),
                               rtol=0, atol=SIN_TOL, err_msg=f"{ctx} max_elev")
    return len(near)


# ---------------------------------------------------------------------------
# the device functions
# ---------------------------------------------------------------------------

def test_sinf_cosf_are_glibcs():
    """The reference's XLA CPU sin/cos (glibc's sinf/cosf) bit for bit,
    over the reduction's three paths (< 0.75, < 120, larger)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 20000), rng.uniform(-120, 120, 60000),
                        rng.uniform(-3e4, 3e4, 20000), [0.0, 1e-5, -2e-4, 0.75, 120.0]]
                       ).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(propagation.sinf(t).numpy(), np.asarray(jnp.sin(x)))
    np.testing.assert_array_equal(propagation.cosf(t).numpy(), np.asarray(jnp.cos(x)))


@pytest.mark.parametrize("seed", SEEDS)
def test_propagate_and_ecef_equal_the_reference(seed):
    times = _grid(seed)
    for jc, tc in _catalog(seed):
        want = jprop.propagate(jc, times)
        got = propagation.propagate(tc, times, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (tc.n_sats, times.size, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(propagation.eci_to_ecef(got, times).numpy(),
                                      np.asarray(jprop.eci_to_ecef(want, times)))


@pytest.mark.parametrize("seed", SEEDS)
def test_sun_and_eclipse_equal_the_reference(seed):
    times = _grid(seed)
    jc, tc = _catalog(seed)[0]
    sun = visibility.sun_direction(times, device="cpu")
    jsun = jvis.sun_direction(times)
    np.testing.assert_array_equal(sun.numpy(), np.asarray(jsun))
    mask = visibility.eclipse_mask(propagation.propagate(tc, times, device="cpu"), sun)
    want = np.asarray(jvis.eclipse_mask(jprop.propagate(jc, times), jsun))
    np.testing.assert_array_equal(mask.numpy(), want)
    assert 0.0 < want.mean() < 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_elevation_within_the_sine_bound(seed):
    times = _grid(seed)
    sites = _sites(8)
    for jc, tc in _catalog(seed):
        want = np.asarray(jvis.elevation_deg(jprop.propagate(jc, times), times, sites))
        got = visibility.elevation_deg(propagation.propagate(tc, times, device="cpu"),
                                       times, sites).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        err = np.abs(np.sin(np.radians(got.astype(np.float64)))
                     - np.sin(np.radians(want.astype(np.float64))))
        assert err.max() <= SIN_TOL, err.max()
        for min_elev in (MIN_ELEV, 10.0):
            _same_passes(visibility.extract_passes(got, times, min_elev),
                         jvis.extract_passes(want, times, min_elev), want, min_elev,
                         f"seed {seed}")


def test_extract_passes_and_eclipse_fractions_equal_on_equal_inputs():
    jc, tc = _catalog(4)[0]
    times = _grid(0)
    pos = jprop.propagate(jc, times)
    elev = np.asarray(jvis.elevation_deg(pos, times, _sites(4)))
    for min_elev in (0.0, 5.0, 25.0):
        got, want = (visibility.extract_passes(torch.from_numpy(elev.copy()), times, min_elev),
                     jvis.extract_passes(elev, times, min_elev))
        assert got.n_passes == want.n_passes > 0
        for f in ("row", "start", "stop", "t_rise", "t_set", "duration_s",
                  "max_elev_deg", "t_culminate"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    mask = np.asarray(jvis.eclipse_mask(pos, jvis.sun_direction(times)))
    bounds = np.array([0, 100, 100, 350, 720])
    np.testing.assert_array_equal(
        visibility.eclipse_fractions(torch.from_numpy(mask.copy()), bounds),
        jvis.eclipse_fractions(mask, bounds))


@pytest.mark.parametrize("seed", SEEDS)
def test_elevation_symmetric_about_the_culmination(seed):
    """Earth rotation frozen, a circular orbit: elevation from a fixed
    site is even about the true culmination t*, which lies within dt/2
    of the grid's maximum k. Samples k - j and k + j then sit in
    [t* + j dt - dt/2, t* + j dt + dt/2], where the elevation falls
    monotonically, so they differ by at most its change over samples
    k + j - 1 .. k + j + 1 (plus float32 round-off)."""
    rng = np.random.default_rng(100 + seed)
    els = elements.walker_delta(1, 1, float(rng.uniform(0, 80)),
                                float(rng.uniform(400, 1200)), phasing=0)
    period = float(propagation.orbital_period_s(els.a_m[0]))
    times = np.arange(0.0, period, 2.0)
    pos = propagation.propagate(els, times, device="cpu")
    elev = None
    for _ in range(50):  # a site the orbit passes over
        site = visibility.station_ecef(rng.uniform(-60, 60), rng.uniform(-180, 180))
        e = visibility.elevation_deg(pos, times, site, omega_rad_s=0.0).numpy()[0, 0]
        k = int(np.argmax(e))
        if e[k] > 0.0 and 5 <= k < e.shape[0] - 6:
            elev = e.astype(np.float64)
            break
    assert elev is not None
    half = min(k, elev.shape[0] - 2 - k, 60)
    j = np.arange(1, half + 1)
    asym = np.abs(elev[k - j] - elev[k + j])
    bound = np.abs(elev[k + j - 1] - elev[k + j + 1]) + 1e-4
    assert (asym <= bound).all(), (asym - bound).max()


# ---------------------------------------------------------------------------
# the scenario bridge and the fleet
# ---------------------------------------------------------------------------

SCENE = dict(name="orbital", scene_px=384, objects_per_scene=(10, 20), object_px=(10, 24),
             cloud_fraction=0.25)


def _orbital_spec(mod, scene, n_sats=4, n_stations=8, n_rounds=2, seed=6):
    """benchmarks/fleet_bench.py's _orbital_spec, cut to 4 satellites and
    2 rounds."""
    sites = jsched.default_sites(n_stations)
    stations = tuple(
        mod.GroundStation(f"gs{k}", bandwidth_mbps=30.0 + 5.0 * (k % 5),
                          contact_s=240.0 + 30.0 * (k % 3), site=sites[k])
        for k in range(n_stations))
    return mod.FleetScenarioSpec(
        n_sats=n_sats, n_rounds=n_rounds, frames_per_pass=1, stations=stations,
        scene_mix=(scene,), seed=seed, geometry="orbital", min_elev_deg=MIN_ELEV)


@pytest.fixture(scope="module")
def orbital():
    jspec = _orbital_spec(jscenarios, JSceneSpec(**SCENE))
    tspec = _orbital_spec(scenarios, SceneSpec(**SCENE))
    return (jspec, jscenarios.generate_scenario(jspec),
            tspec, scenarios.generate_scenario(tspec, device="cpu"))


def test_spec_elements_and_sites_match_reference(orbital):
    jspec, _, tspec, _ = orbital
    assert schedule.default_sites(11) == jsched.default_sites(11)
    for a, b in zip(schedule.spec_elements(tspec).arrays(), jsched.spec_elements(jspec).arrays()):
        np.testing.assert_array_equal(a, b)


def test_orbital_scenario_matches_reference(orbital):
    jspec, jsc, tspec, tsc = orbital
    # the passes under the edge rule, from each side's own elevation grid
    dt = jspec.time_step_s
    n_steps = max(int(round(jspec.n_rounds * jspec.pass_s / dt)), jspec.n_rounds)
    times = np.arange(n_steps, dtype=np.float64) * dt
    sites = np.stack([jvis.station_ecef(*st.site) for st in jspec.stations])
    want_elev = np.asarray(jvis.elevation_deg(
        jprop.propagate(jsched.spec_elements(jspec), times), times, sites))
    got_elev = visibility.elevation_deg(propagation.propagate(
        schedule.spec_elements(tspec), times, device="cpu"), times, sites)
    n_near = _same_passes(visibility.extract_passes(got_elev, times, MIN_ELEV),
                          jvis.extract_passes(want_elev, times, MIN_ELEV),
                          want_elev, MIN_ELEV, "orbital scenario")
    assert n_near == 0  # so every contact below must match
    n_contacts = 0
    for jr, tr in zip(jsc.rounds, tsc.rounds, strict=True):
        assert [(c.sat, c.station.name) for c in tr.contacts] == \
            [(c.sat, c.station.name) for c in jr.contacts]
        np.testing.assert_allclose([c.budget_bytes for c in tr.contacts],
                                   [c.budget_bytes for c in jr.contacts], rtol=BUDGET_RTOL, atol=0)
        np.testing.assert_allclose([c.bandwidth_mbps for c in tr.contacts],
                                   [c.bandwidth_mbps for c in jr.contacts], rtol=BUDGET_RTOL,
                                   atol=0)
        n_contacts += len(tr.contacts)
        for jp, tp in zip(jr.passes, tr.passes, strict=True):
            assert (tp.sat, tp.harvest_j, tp.sunlit) == (jp.sat, jp.harvest_j, jp.sunlit)
            for (ji, jb, jc), (ti, tb, tc) in zip(jp.frames, tp.frames, strict=True):
                np.testing.assert_array_equal(ti, ji)
                np.testing.assert_array_equal(tb, jb)
                np.testing.assert_array_equal(tc, jc)
    assert n_contacts > 0


def test_orbital_requires_sites_as_the_reference():
    with pytest.raises(ValueError, match="site") as want:
        jscenarios.generate_scenario(jscenarios.FleetScenarioSpec(geometry="orbital"))
    with pytest.raises(ValueError, match="site") as got:
        scenarios.generate_scenario(scenarios.FleetScenarioSpec(geometry="orbital"),
                                    device="cpu")
    assert str(got.value) == str(want.value).replace("repro.orbits", "repro_torch.orbits")


def _port_scenario(jsc, tspec):
    """The reference's scenario object by object, as the port's types."""
    rounds = []
    for jr in jsc.rounds:
        st = {s.name: s for s in tspec.stations}
        rounds.append(scenarios.Round(
            index=jr.index,
            passes=[scenarios.PassEvent(sat=p.sat, frames=p.frames, harvest_j=p.harvest_j,
                                        sunlit=p.sunlit) for p in jr.passes],
            contacts=[scenarios.ContactEvent(sat=c.sat, station=st[c.station.name],
                                             bandwidth_mbps=c.bandwidth_mbps,
                                             budget_bytes=c.budget_bytes)
                      for c in jr.contacts]))
    return scenarios.FleetScenario(spec=tspec, rounds=rounds)


@pytest.mark.parametrize("method", ["ground_only", "tiansuan"])
def test_fleet_on_the_reference_orbital_scenario(method, orbital, counters):
    jspec, jsc, tspec, _ = orbital
    (sp, _), (gd, _) = counters
    port = ((params_from_jax(sp), reduced(get_config("targetfuse-space"))),
            (params_from_jax(gd), reduced(get_config("targetfuse-ground"))))
    want, jf = jrun_scenario(*counters, JConfig(method=method, score_thresh=0.25), jsc)
    got, tf = fleet.run_scenario(*port, PipelineConfig(method=method, score_thresh=0.25),
                                 _port_scenario(jsc, tspec), device="cpu")
    assert tf.summary()["windows_served"] == jf.summary()["windows_served"] > 0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_array_equal(a.per_tile_pred, b.per_tile_pred, err_msg=f"sat{i}")
        assert a.summary() == b.summary(), f"sat{i}"
    for f in LEDGER:
        np.testing.assert_array_equal(getattr(tf.ledger, f)[:4], getattr(jf.ledger, f)[:4],
                                      err_msg=f)


@pytest.mark.parametrize("kw", [
    dict(ecc=np.array([0.3])), dict(a_m=np.array([6.4e6])), dict(inc_rad=np.array([4.0])),
    dict(m0_rad=np.array([np.nan])), dict(raan_rad=np.zeros((1, 1))),
])
def test_element_validation_matches_reference(kw):
    base = dict(a_m=np.array([7e6]), ecc=np.zeros(1), inc_rad=np.zeros(1),
                raan_rad=np.zeros(1), argp_rad=np.zeros(1), m0_rad=np.zeros(1)) | kw
    with pytest.raises(ValueError) as want:
        jel.OrbitalElements(**base)
    with pytest.raises(ValueError) as got:
        elements.OrbitalElements(**base)
    assert str(got.value) == str(want.value)
