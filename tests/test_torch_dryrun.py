"""The port's dry run (``repro_torch.launch.dryrun``), its collective
counter (``launch.roofline.count_collectives``) and its tables
(``launch.report``), on the CPU.

``python -m repro_torch.launch.dryrun`` runs in a subprocess of its own
(it brings up a ``fake`` process group, which must not stay in a test
worker) on ``tinymulti`` (2, 2, 2) for the reference test's three cells
(``test_distributed.py::test_dryrun_tiny_mesh_subprocess``) and a
counter's serve cell: each prints ``[ok]`` and writes its record, which
must hold per-device FLOPs, bytes, a peak no smaller than the arguments,
the reference's keys, and no device memory. ``qwen2-moe-a2.7b
decode_32k`` is the cell that fails on the reference's side only. The
collective counter, and the dry run's counting mode built on it, give
the reference ``test_collective_parser``'s bytes and ring factors on
known redistributions, in a subprocess.
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = [("vit-l16", "serve_b1"), ("dit-s2", "gen_fast"), ("qwen2-moe-a2.7b", "decode_32k"),
         ("targetfuse-space", "tiles_416_b256")]


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                CUDA_VISIBLE_DEVICES="")


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_dryrun_tinymulti_subprocess(cell, tmp_path):
    arch, shape = cell
    hlo = tmp_path / "ops.txt"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--mesh", "tinymulti", "--hlo-out", str(hlo)],
                       capture_output=True, text=True, env=_env(), timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert f"[ok] {arch} x {shape} @ tinymulti" in r.stdout
    path = os.path.join(SRC, "..", "artifacts", "dryrun_torch", "tinymulti",
                        f"{arch}__{shape}__unroll-True.json")
    with open(path) as f:
        rec = json.load(f)
    m, rl = rec["memory_analysis"], rec["roofline"]
    assert rec["n_chips"] == 8 and rec["mesh_shape"] == [2, 2, 2]
    assert rl["flops_per_dev"] > 0 and rl["hbm_bytes_per_dev"] > 0
    assert m["argument_bytes"] > 0 and m["peak_bytes"] >= m["argument_bytes"]
    assert set(rec["collective_counts"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                             "all-to-all", "collective-permute"}
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert hlo.read_text().count("\n") == rec["local_ops"]


_COLLECTIVES = r"""
import contextlib, json, torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch.dryrun import _Hidden, _Live, _counting_mode, fake_group
from repro_torch.launch.roofline import count_collectives
fake_group(8)
mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
res = {}
for counter in ("count_collectives", "dryrun"):
    for how in ("redistribute", "in_op"):
        if counter == "count_collectives":
            mode, counts = count_collectives()
            hidden = contextlib.nullcontext()
        else:   # the dry run's own counting mode, as run_cell sets it up
            mode, _ = _counting_mode(_Live(), None)
            counts, hidden = mode.collectives, _Hidden(mode)
        with mode:
            ag = DTensor.from_local(torch.empty(2, 1024, dtype=torch.bfloat16), mesh,
                                    [Shard(0)], shape=(16, 1024), stride=(1024, 1),
                                    run_check=False)
            a = DTensor.from_local(torch.empty(16, 16), mesh, [Shard(1)], shape=(16, 128),
                                   stride=(128, 1), run_check=False)
            b = DTensor.from_local(torch.empty(16, 16), mesh, [Shard(0)], shape=(128, 16),
                                   stride=(16, 1), run_check=False)
            mode.counting = True
            with hidden:
                if how == "redistribute":
                    ag.redistribute(mesh, [Replicate()])
                    (a @ b).redistribute(mesh, [Replicate()])
                else:   # collectives that DTensor's dispatch inserts into an op
                    torch.softmax(ag, dim=0)
                    (a @ b) + 1
        res[f"{counter} {how}"] = counts.as_dict()
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def collectives():
    """Both counters' counts on both sets of ops, from one subprocess."""
    r = subprocess.run([sys.executable, "-c", _COLLECTIVES], capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _the_reference_parsers_counts(c):
    """An all-gather of (2, 1024) bf16 shards into (16, 1024) and an
    all-reduce of a (16, 16) float32 partial sum: the reference's parser
    counts the all-gather's result bytes once and the all-reduce's
    twice."""
    assert c["all-gather"] == 16 * 1024 * 2
    assert c["all-reduce"] == 256 * 4 * 2
    assert c["counts"] == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 0,
                           "all-to-all": 0, "collective-permute": 0}
    assert c["total"] == c["all-gather"] + c["all-reduce"]


def test_count_collectives_matches_the_reference_parser(collectives):
    _the_reference_parsers_counts(collectives["count_collectives redistribute"])


@pytest.mark.parametrize("how", ["redistribute", "in_op"])
def test_dryrun_counts_collectives_as_the_reference_parser(how, collectives):
    """The dry run's counting mode, on explicit redistributions and on
    the ones DTensor's dispatch inserts into a softmax over the sharded
    dim and an add to a partial sum, gives the reference parser's counts,
    as ``count_collectives`` does on the same ops."""
    c = collectives[f"dryrun {how}"]
    _the_reference_parsers_counts(c)
    assert c == collectives[f"count_collectives {how}"]


def test_roofline_terms():
    from repro_torch.launch import roofline as R
    rl = R.Roofline(flops=989e12, bytes_hbm=3.35e12, bytes_coll=450e9, n_chips=8,
                    model_flops_total=8 * 989e12)
    assert rl.compute_s == pytest.approx(1.0) and rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == pytest.approx(1.0) and rl.useful_ratio == pytest.approx(1.0)
    big = R.Roofline(flops=0, bytes_hbm=1, bytes_coll=50e9, n_chips=16, min_bytes=3.35e12)
    assert big.collective_s == pytest.approx(1.0) and big.memory_s == pytest.approx(1.0)
    assert big.dominant in ("memory", "collective")
    import torch
    assert R.collective_kind(torch.ops._c10d_functional.all_reduce.default) == "all-reduce"
    assert R.collective_kind(torch.ops.aten.mm.default) is None


def test_report_renders_records(tmp_path):
    from repro_torch.launch import report
    rec = {"arch": "qwen3-8b", "shape": "train_4k", "mesh": "tiny", "n_chips": 8,
           "trace_s": 12.0,
           "memory_analysis": {"argument_bytes": 2e9, "output_bytes": 2e9, "peak_bytes": 9e9},
           "collective_counts": {"all-gather": 3, "all-reduce": 4, "reduce-scatter": 1,
                                 "all-to-all": 0, "collective-permute": 0},
           "roofline": {"flops_per_dev": 1e15, "hbm_bytes_per_dev": 5e12,
                        "coll_bytes_per_dev": 1e10}}
    (tmp_path / "tiny").mkdir()
    for i, shape in enumerate(("train_4k", "prefill_32k")):
        with open(tmp_path / "tiny" / f"qwen3-8b__{shape}.json", "w") as f:
            json.dump(dict(rec, shape=shape), f)
    recs = report.load("tiny", str(tmp_path))
    assert [r["shape"] for r in recs] == ["prefill_32k", "train_4k"]
    rt = report.roofline_table("tiny", str(tmp_path)).splitlines()
    assert len(rt) == 4 and "**memory**" in rt[2] and "qwen3-8b" in rt[3]
    dt = report.dryrun_table("tiny", str(tmp_path)).splitlines()
    assert len(dt) == 4 and "| 3 | 4 | 1 | 0 | 0 |" in dt[2] and "9.00G" in dt[2]
