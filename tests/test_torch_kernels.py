"""The port's kernel layer against the reference's, on the CPU.

Each plain PyTorch version (``repro_torch.kernels.ref``) is held against
the reference's oracle (``repro.kernels.ref``) on the shapes of
tests/test_kernels.py and on the shapes the Mission path gives it, with
inputs made from a seed in numpy (attention: tests/test_torch_lm.py).
The CUDA kernels themselves run only on a card (``chip_smoke.py``); here
their wrappers must import and build nothing. Also: the port's threefry
``randint`` against JAX's, and the import guard (the port loads neither
JAX nor ``repro``, and its entry points need a card by default).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.int8_matmul import int8_matmul as pallas_int8
from repro.kernels.iou import iou_matrix as pallas_iou
from repro.kernels.kmeans_assign import kmeans_assign as pallas_kmeans
from repro.kernels.ops import quantize_int8 as jquantize
from repro.kernels.tile_moments import tile_moments as pallas_moments
from repro_torch import random as trandom
from repro_torch.kernels import _build, ops, ref

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default pool (one thread per core) in each of them would
# starve the timing-sensitive tests of other files
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _boxes(rng, *shape):
    b = rng.random((*shape, 4), dtype=np.float32)
    b[..., 2:] = b[..., :2] + np.abs(b[..., 2:]) + 0.01
    return b


# ---------------------------------------------------------------------------
# tile moments: atol 1e-4 is the reference's own kernel tolerance
# (tests/test_kernels.py). The reference sums in float32, the port in
# float64 (as its CUDA kernel), and the cube root of a small third moment
# magnifies the reference's rounding; measured within ~1e-5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,h,w,c", [(16, 32, 32, 3), (100, 16, 16, 3),
                                     (7, 64, 64, 1), (130, 8, 8, 4),
                                     (130, 64, 64, 3)])
def test_tile_moments_matches_reference(n, h, w, c):
    t = np.random.default_rng(0).random((n, h, w, c), dtype=np.float32)
    np.testing.assert_allclose(ref.tile_moments(torch.from_numpy(t)).numpy(),
                               np.asarray(jref.tile_moments(t)),
                               atol=1e-4, rtol=1e-4)


def test_tile_moments_matches_pallas_interpret():
    t = np.random.default_rng(1).random((130, 64, 64, 3), dtype=np.float32)
    np.testing.assert_allclose(ref.tile_moments(torch.from_numpy(t)).numpy(),
                               np.asarray(pallas_moments(t, interpret=True)),
                               atol=1e-4, rtol=1e-4)


def test_tile_moments_zero_tiles():
    """Zero tiles pad every capture bucket: mean 0, sd sqrt(1e-12), skew 0."""
    out = ref.tile_moments(torch.zeros(2, 8, 8, 3)).numpy()
    np.testing.assert_array_equal(out[:, :3], 0.0)
    np.testing.assert_allclose(out[:, 3:6], 1e-6, rtol=1e-6)
    np.testing.assert_array_equal(out[:, 6:], 0.0)


# ---------------------------------------------------------------------------
# kmeans assign: assignments equal; d2 within the reference's own 1e-4
# (both sum as fused multiply-add chains in index order, so d2 is
# usually bit-equal)
# ---------------------------------------------------------------------------

def _planted(n, d, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    if k > 1:
        c[k // 2] = c[0]      # duplicate centroid: every tie goes to 0
        c[-1] = x[3]          # an exact hit: d2 = 0
    x[5] = x[3]               # duplicate rows
    return x, c


@pytest.mark.parametrize("n,d,k", [(64, 9, 4), (1000, 9, 16), (513, 32, 7),
                                   (256, 128, 64), (128, 9, 1), (128, 9, 64),
                                   (1024, 9, 512)])
def test_kmeans_assign_matches_reference(n, d, k):
    x, c = _planted(n, d, k, seed=n + k)
    a1, d1 = ref.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    a2, d2 = jref.kmeans_assign(x, c)
    assert a1.dtype == torch.int32
    np.testing.assert_array_equal(a1.numpy(), np.asarray(a2))
    np.testing.assert_allclose(d1.numpy(), np.asarray(d2), atol=1e-4, rtol=1e-4)
    if k > 1:
        assert not (a1.numpy() == k // 2).any()  # the duplicate never wins


def test_kmeans_assign_matches_pallas_interpret():
    x, c = _planted(128, 9, 64, seed=3)
    a1, d1 = ref.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    a2, d2 = pallas_kmeans(x, c, interpret=True)
    np.testing.assert_array_equal(a1.numpy(), np.asarray(a2))
    np.testing.assert_allclose(d1.numpy(), np.asarray(d2), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# IoU: atol 1e-5, the reference's own kernel tolerance (XLA may contract
# the union into a fused multiply-add; the port rounds every step)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(10, 10), (128, 64), (200, 300), (1, 5)])
def test_iou_matrix_matches_reference(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    a, b = _boxes(rng, n), _boxes(rng, m)
    out = ref.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, np.asarray(jref.iou_matrix(a, b)), atol=1e-5)
    assert out.max() <= 1.0 + 1e-6 and out.min() >= 0.0


def test_iou_matrix_batched_main_path_shape():
    """(4, 128, 4) boxes, as the NMS of a counting batch gives them: each
    batch row equals the unbatched reference and the Pallas kernel."""
    rng = np.random.default_rng(7)
    a = _boxes(rng, 4, 128)
    out = ref.iou_matrix(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert out.shape == (4, 128, 128)
    for i in range(4):
        np.testing.assert_allclose(out[i], np.asarray(jref.iou_matrix(a[i], a[i])),
                                   atol=1e-5)
        np.testing.assert_allclose(
            out[i], np.asarray(pallas_iou(a[i], a[i], interpret=True)), atol=1e-5)
    np.testing.assert_allclose(np.diagonal(out, axis1=1, axis2=2), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# int8 matmul: exact int32 sums, so bit-equal to the reference's oracle
# and to the Pallas kernel (whose own test allows rtol 1e-6)
# ---------------------------------------------------------------------------

def _int8_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = (rng.random(m) + 0.1).astype(np.float32)
    ws = (rng.random(n) + 0.1).astype(np.float32)
    return xq, wq, xs, ws


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (100, 200, 150),
                                   (256, 512, 384), (1, 64, 1)])
def test_int8_matmul_matches_reference_bit_for_bit(m, k, n):
    xq, wq, xs, ws = _int8_inputs(m, k, n, seed=m + k + n)
    got = ref.int8_matmul(*(torch.from_numpy(a) for a in (xq, wq, xs, ws))).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got, np.asarray(jref.int8_matmul(xq, wq, xs, ws)))
    np.testing.assert_array_equal(got, np.asarray(pallas_int8(xq, wq, xs, ws, interpret=True)))


def test_int8_matmul_extreme_values_are_exact():
    """Every product at +-127 * -127 over K = 4096: |acc| = 66,064,384,
    past float32's 24-bit integers, so only an exact integer sum rounded
    once agrees."""
    xq = np.full((3, 4096), -127, np.int8)
    xq[1] = 127
    wq = np.full((4096, 2), -127, np.int8)
    wq[::3, 1] = 126
    one = np.ones(3, np.float32), np.ones(2, np.float32)
    got = ref.int8_matmul(*(torch.from_numpy(a) for a in (xq, wq, *one))).numpy()
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(jref.int8_matmul(xq, wq, *one)))


@pytest.mark.parametrize("dim", [0, 1])
def test_quantize_int8_matches_reference(dim):
    """Equal int8 values and scales. Row 0's largest value is 127, so its
    per-row scale is 1 and its exact halves must round to even."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 127.0]
    q, s = ops.quantize_int8(torch.from_numpy(x), dim)
    jq, js = jquantize(x, axis=dim)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if dim == 1:
        assert q[0, :4].tolist() == [0, 2, -2, 127]


# ---------------------------------------------------------------------------
# dispatch and the CUDA wrappers, here without nvcc or a card
# ---------------------------------------------------------------------------

def test_ops_sends_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.random((3, 8, 8, 3), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((20, 9)).astype(np.float32))
    b = torch.from_numpy(_boxes(rng, 2, 6))
    before = [(k.launches, k._lib) for k in ops.KERNELS]
    assert torch.equal(ops.tile_moments(t), ref.tile_moments(t))
    for got, want in zip(ops.kmeans_assign(x, x[:4]), ref.kmeans_assign(x, x[:4])):
        assert torch.equal(got, want)
    assert torch.equal(ops.iou_matrix(b, b), ref.iou_matrix(b, b))
    xq, wq, xs, ws = (torch.from_numpy(a) for a in _int8_inputs(5, 70, 3, seed=0))
    assert torch.equal(ops.int8_matmul(xq, wq, xs, ws), ref.int8_matmul(xq, wq, xs, ws))
    assert [(k.launches, k._lib) for k in ops.KERNELS] == before
    assert before == [(0, None)] * len(ops.KERNELS) and len(ops.KERNELS) == 5


@pytest.mark.parametrize("call", [
    lambda: ops._moments.tile_moments(torch.zeros(1, 4, 4, 3)),
    lambda: ops._kmeans.kmeans_assign(torch.zeros(4, 9), torch.zeros(2, 9)),
    lambda: ops._iou.iou_matrix(torch.zeros(3, 4), torch.zeros(3, 4)),
    lambda: ops._flash.flash_attention(*[torch.zeros(1, 8, 2, 16)] * 3, causal=True),
    lambda: ops._int8.int8_matmul(torch.zeros(2, 4, dtype=torch.int8),
                                  torch.zeros(4, 3, dtype=torch.int8),
                                  torch.ones(2), torch.ones(3)),
])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: it never computes on the CPU."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_cuda_kernels_are_named_and_hashed_without_building():
    for k in ops.KERNELS:
        assert k.source.exists(), k.source
        path = k.lib_path()
        assert path.parent == _build.BUILD_DIR and k.name in path.name
        assert "sm_90a" in " ".join(_build.FLAGS)
        assert "--use_fast_math" not in _build.FLAGS


# ---------------------------------------------------------------------------
# the first k-means++ centroid: JAX's threefry draw, bit for bit
# ---------------------------------------------------------------------------

def test_randint_matches_jax():
    seeds = list(range(0, 25)) + [123456, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 + 7,
                                  -1, -12345]
    ns = [1, 2, 5, 7, 64, 100, 127, 128, 300, 1023, 65537, 2 ** 31 - 1]
    pairs = [(s, n) for s in seeds for n in ns]
    assert len(pairs) >= 200
    for s, n in pairs:
        want = int(jax.random.randint(jax.random.PRNGKey(s), (), 0, n))
        assert trandom.randint(s, n) == want, (s, n)


def test_randint_matches_jax_with_traced_bound():
    """The dedup core draws with a traced ``n`` inside jit."""
    f = jax.jit(lambda key, n: jax.random.randint(key, (), 0, n))
    for s, n in [(0, 27), (3, 500), (7, 128), (11, 5)]:
        assert trandom.randint(s, n) == int(f(jax.random.PRNGKey(s), jnp.int32(n)))


# ---------------------------------------------------------------------------
# import guard: the port loads neither JAX nor the reference package, and
# its entry points refuse to run quietly on the CPU
# ---------------------------------------------------------------------------

_GUARD = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert len(mods) >= 24, mods
for m in ("repro_torch.models.lm", "repro_torch.kernels.flash_attention",
          "repro_torch.kernels.int8_matmul", "repro_torch.configs.qwen3_8b"):
    assert m in mods, m
import torch
assert not torch.cuda.is_available()
from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import prepare_frames
from repro_torch.core.mission import Mission
from repro_torch.core.pipeline import run_pipeline
from repro_torch.models import detector, lm
cfg = reduced(get_config("targetfuse-space"))
lm_cfg = reduced(get_config("qwen3-8b"))
p = detector.init(torch.Generator().manual_seed(0), cfg, device="cpu")
for call in (lambda: Mission((p, cfg), (p, cfg)),
             lambda: run_pipeline([], (p, cfg), (p, cfg)),
             lambda: prepare_frames([], 128, 64, 64),
             lambda: detector.init(torch.Generator().manual_seed(0), cfg),
             lambda: lm.init(torch.Generator().manual_seed(0), lm_cfg),
             lambda: lm.init_cache(lm_cfg, 1, 8)):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("ran without a GPU")
print("GUARD-OK", len(mods))
"""


def test_port_imports_no_jax_and_needs_a_gpu_by_default():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _GUARD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "GUARD-OK" in out.stdout


# ---------------------------------------------------------------------------
# the entry points' default device, in this process: "cuda", which raises
# without a card (torch.cuda.is_available patched, so the test means the
# same on a machine with one), and turns reduced-precision bf16 sums off
# ---------------------------------------------------------------------------

def test_prepare_frames_and_detector_init_default_to_the_card(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import engine
    from repro_torch.models import detector
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("targetfuse-space"))
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.prepare_frames([], 128, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        detector.init(torch.Generator().manual_seed(0), cfg)
    p = detector.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert p["stem"].device.type == "cpu"
    assert engine.prepare_frames([], 128, 64, 64, device="cpu").n == 0


def test_resolve_device_sets_full_precision_products(monkeypatch):
    from repro_torch.device import resolve_device
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction,
             torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        flags.allow_bf16_reduced_precision_reduction = True
        assert resolve_device("cuda").type == "cuda"
        assert not flags.allow_bf16_reduced_precision_reduction
        assert not flags.allow_tf32 and not torch.backends.cudnn.allow_tf32
    finally:
        (flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction,
         torch.backends.cudnn.allow_tf32) = saved
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
