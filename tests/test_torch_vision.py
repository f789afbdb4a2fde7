"""The port's vision serving path against the reference, on the CPU.

The same inputs, made from a seed with numpy, go through ``repro`` and
``repro_torch``: the layers the vision models add (LayerNorm, GroupNorm,
the GELU MLP, the sinusoidal embedding, BatchNorm, VALID, depthwise and
asymmetric SAME convolutions, the SAME max-pool), the configs and shape
sets, the init layout, and ``forward`` of reduced ViT-L/16, ViT-H/14,
ConvNeXt-B and ResNet-152 from the reference's own seeded weights carried
over by ``from_numpy``. ViT's attention on the card is the
``flash_attention`` kernel; its D 80 route (ViT-H/14's heads) is emulated
in ``test_torch_flash_route.py``, and ``chip_smoke.py`` runs it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.configs.base import get_shape as jget_shape
from repro.configs.base import get_shapes as jget_shapes
from repro.configs.base import to_dict as jto_dict
from repro.models import convnext as jconvnext
from repro.models import layers as JL
from repro.models import resnet as jresnet
from repro.models import vit as jvit
from repro_torch import tree
from repro_torch.configs import get_config, get_shape, get_shapes, reduced, to_dict
from repro_torch.models import convnext, resnet, vit
from repro_torch.models import layers as L

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

VISION_ARCHS = ("vit-l16", "vit-h14", "convnext-b", "resnet-152")
MODULES = {"vit": (jvit, vit), "convnext": (jconvnext, convnext), "resnet": (jresnet, resnet)}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_bf16_rounds_as(got, want):
    """bf16 ``got`` rounds where ``want`` does: 99% of the values equal
    bit for bit, the rest within one bf16 ulp (2**-7 of the value)."""
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.mean(got == want) >= 0.99
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))


# ---------------------------------------------------------------------------
# layers: atol 1e-6 in float32 (sums in another order, XLA's and torch's
# tanh, exp, sin, cos and rsqrt may differ in the last bit); in bf16 each
# output rounds where the reference's does
# ---------------------------------------------------------------------------

def _layer_cases(rng):
    """name -> (the reference's function, the port's, float32 inputs)."""
    x = rng.standard_normal((2, 5, 6, 48)).astype(np.float32) * 2 + 0.5
    scale, bias = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    w_in = rng.standard_normal((48, 96)).astype(np.float32) / 7
    b_in = rng.standard_normal(96).astype(np.float32) / 4
    w_out = rng.standard_normal((96, 48)).astype(np.float32) / 10
    b_out = rng.standard_normal(48).astype(np.float32) / 4
    mean = rng.standard_normal(48).astype(np.float32)
    var = rng.random(48).astype(np.float32) + 0.1
    return {
        "layernorm": (JL.layernorm, L.layernorm, (x, scale, bias)),
        # 32 groups do not divide 48: the count shrinks to 24
        "groupnorm": (JL.groupnorm, L.groupnorm, (x, scale, bias)),
        "gelu": (jax.nn.gelu, L.gelu, (x,)),
        "gelu_mlp": (JL.gelu_mlp, L.gelu_mlp, (x, w_in, b_in, w_out, b_out)),
        "batchnorm_train": (JL.batchnorm_train, L.batchnorm_train, (x, scale, bias)),
        "batchnorm_eval": (JL.batchnorm_eval, L.batchnorm_eval, (x, scale, bias, mean, var)),
    }


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", ["layernorm", "groupnorm", "gelu", "gelu_mlp",
                                  "batchnorm_train", "batchnorm_eval"])
def test_layer_matches_reference_in_float32(name):
    jfn, fn, args = _layer_cases(np.random.default_rng(0))[name]
    got, want = _outputs(fn(*_t(*args))), _outputs(jfn(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["layernorm", "groupnorm", "gelu", "gelu_mlp",
                                  "batchnorm_train", "batchnorm_eval"])
def test_layer_rounds_as_reference_in_bf16(name):
    """bf16 activations (and weights; BatchNorm's running statistics stay
    float32, as ResNet keeps them): the outputs in bf16 round where the
    reference's do, BatchNorm's batch statistics (float32) within 1e-6."""
    jfn, fn, args = _layer_cases(np.random.default_rng(1))[name]
    keep32 = {3, 4} if name == "batchnorm_eval" else set()
    got = _outputs(fn(*(t if i in keep32 else t.bfloat16() for i, t in enumerate(_t(*args)))))
    want = _outputs(jfn(*(jnp.asarray(a) if i in keep32 else jnp.asarray(a, jnp.bfloat16)
                          for i, a in enumerate(args))))
    _assert_bf16_rounds_as(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu``'s default is the tanh approximation; the erf form
    (``F.gelu``'s default) differs by up to ~5e-4."""
    xs = np.linspace(-6, 6, 2401, dtype=np.float32)
    got = L.gelu(torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(xs)), atol=1e-6)
    assert (got - torch.nn.functional.gelu(torch.from_numpy(xs))).abs().max() > 1e-4
    np.testing.assert_array_equal(
        L.gelu(torch.from_numpy(xs).bfloat16()).float().numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(xs, jnp.bfloat16)), np.float32))


@pytest.mark.parametrize("dim,max_period", [(64, 10000.0), (33, 10000.0), (128, 1000.0)])
def test_sinusoidal_embedding_matches_reference(dim, max_period):
    """atol 1e-6 plus one float32 ulp of a frequency (at most 2**-23, the
    frequencies lie in (0, 1]) times the timestep: XLA's float32 ``exp``
    and torch's differ in the last bit of a few frequencies (torch's is
    the correctly rounded one at all but one, XLA's at 4-6 of 32-64 lose
    a bit), and the timestep multiplies that into the angle. Timesteps
    0-7 are held at 1e-6; the port is within 3.5e-8 of float64 sin / cos
    of its own angles."""
    t = np.array([0, 1, 7, 250, 999], np.int32)
    got = L.sinusoidal_embedding(torch.from_numpy(t), dim, max_period)
    want = np.asarray(JL.sinusoidal_embedding(jnp.asarray(t), dim, max_period))
    assert got.dtype == torch.float32 and got.shape == want.shape == (5, 2 * (dim // 2))
    atol = 1e-6 + 2.0 ** -23 * t[:, None]
    assert np.all(np.abs(got.numpy() - want) <= atol)


# ---------------------------------------------------------------------------
# convolutions: atol 1e-5 (float32 sums in another order)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,hw,w_shape,stride,padding,groups", [
    ("patchify 16", (32, 48), (16, 16, 3, 8), 16, "VALID", 1),
    ("patchify 14 (ragged edge)", (30, 30), (14, 14, 3, 8), 14, "VALID", 1),
    ("downsample 2x2", (8, 8), (2, 2, 8, 12), 2, "VALID", 1),
    ("depthwise 7x7", (9, 9), (7, 7, 1, 16), 1, "SAME", 16),
    ("grouped 3x3", (9, 9), (3, 3, 4, 16), 1, "SAME", 4),
    ("stem 7x7 stride 2, pads (2, 3)", (32, 32), (7, 7, 3, 8), 2, "SAME", 1),
    ("3x3 stride 2, pads (0, 1)", (16, 16), (3, 3, 8, 8), 2, "SAME", 1),
])
def test_conv2d_matches_reference(case, hw, w_shape, stride, padding, groups):
    rng = np.random.default_rng(len(case))
    c_in = w_shape[2] * groups
    x = rng.standard_normal((2, *hw, c_in)).astype(np.float32)
    w = rng.standard_normal(w_shape).astype(np.float32) / 5
    got = L.conv2d(*_t(x, w), stride=stride, padding=padding, groups=groups)
    want = np.asarray(JL.conv2d(x, w, stride=stride, padding=padding, groups=groups))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("hw", [(112, 112), (9, 10), (8, 8)])
def test_max_pool_same_matches_reduce_window(hw):
    """ResNet's 3x3 stride-2 SAME max-pool: at 112 px XLA pads (0, 1) with
    -inf, which a symmetric ``F.max_pool2d`` padding does not give."""
    x = np.random.default_rng(hw[0]).standard_normal((2, *hw, 4)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                            (1, 2, 2, 1), "SAME"))
    np.testing.assert_array_equal(L.max_pool_same(torch.from_numpy(x), 3, 2).numpy(), want)


# ---------------------------------------------------------------------------
# configs and shape sets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", VISION_ARCHS + ("ssd-mobilenetv2",))
def test_configs_match_reference(arch):
    """Fields as dicts (the port leaves out the reference's ``scan_layers``
    of a vision config: its layers run in a loop; ``remat`` is kept),
    ``n_params``, of the config and of ``reduced``."""
    for c, j in ((get_config(arch), jget(arch)), (reduced(get_config(arch)), jreduced(jget(arch)))):
        got, want = to_dict(c), jto_dict(j)
        assert set(want) - set(got) <= {"scan_layers"}
        assert got == {k: want[k] for k in got}
        assert c.n_params == j.n_params


@pytest.mark.parametrize("arch", VISION_ARCHS + ("ssd-mobilenetv2", "qwen3-8b"))
def test_shapes_match_reference(arch):
    assert [dataclasses.astuple(s) for s in get_shapes(arch)] == \
        [dataclasses.astuple(s) for s in jget_shapes(arch)]
    for s in get_shapes(arch):
        assert get_shape(arch, s.name) == s
        assert dataclasses.astuple(jget_shape(arch, s.name)) == dataclasses.astuple(s)
    with pytest.raises(KeyError):
        get_shape(arch, "no_such_shape")


# ---------------------------------------------------------------------------
# init and the weight bridge
# ---------------------------------------------------------------------------

def _jpaths(tree_):
    """The reference tree's (path, leaf) in JAX's order, paths joined
    with "/" as ``repro_torch.tree`` joins them."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return [("/".join(key(k) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree_)[0]]


def _init(mod, cfg, seed=0):
    return mod.init(torch.Generator().manual_seed(seed), cfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", VISION_ARCHS)
def test_init_has_the_reference_layout(arch, dtype):
    """Paths, shapes and dtypes of every leaf (ResNet: params and state;
    its running statistics float32 in a bf16 model) equal the
    reference's, in JAX's leaf order."""
    cfg = dataclasses.replace(reduced(get_config(arch)), param_dtype=dtype)
    jcfg = dataclasses.replace(jreduced(jget(arch)), param_dtype=dtype)
    jmod, mod = MODULES[cfg.kind]
    jp = jax.eval_shape(lambda key: jmod.init(key, jcfg), jax.random.PRNGKey(0))
    paths, leaves = tree.flatten_with_paths(_init(mod, cfg))
    want = _jpaths(jp)
    assert paths == [p for p, _ in want]
    for path, t, (_, j) in zip(paths, leaves, want):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype), path


def test_init_draws_the_reference_distributions():
    cfg = get_config("vit-l16")
    p = _init(vit, dataclasses.replace(reduced(cfg), d_model=256, d_ff=512, n_heads=4))
    assert abs(p["blocks"]["wqkv"].std().item() - 0.88 / 256 ** 0.5) < 0.01  # ±2σ cut
    assert abs(p["pos"].std().item() - 0.88 * 0.02) < 0.002
    p = _init(convnext, reduced(get_config("convnext-b")))
    assert bool((p["stages"][0]["gamma"] == 1e-6).all())
    _, s = _init(resnet, reduced(get_config("resnet-152")))
    assert bool((s["stages"][1][0]["bn2"]["var"] == 1).all())


def test_from_numpy_carries_bf16_exactly_and_keeps_float32_leaves():
    jcfg = dataclasses.replace(jreduced(jget("resnet-152")), param_dtype="bfloat16")
    jp = jresnet.init(jax.random.PRNGKey(1), jcfg)
    got = resnet.from_numpy(jp, device="cpu")
    assert isinstance(got, tuple) and isinstance(got[0]["stages"], list)
    for (path, t), (_, j) in zip(zip(*tree.flatten_with_paths(got)), _jpaths(jp)):
        assert str(t.dtype)[6:] == str(j.dtype), path
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    assert got[1]["stem_bn"]["mean"].dtype == torch.float32


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card (``torch.cuda.is_available`` patched, so the test
    means the same on a machine with one) ``init`` and ``from_numpy``
    raise unless the caller passes ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in VISION_ARCHS:
        cfg = reduced(get_config(arch))
        mod = MODULES[cfg.kind][1]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.init(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.from_numpy(_init(mod, cfg))


# ---------------------------------------------------------------------------
# forward from bridged weights. float32: atol 1e-5 (float32 sums in
# another order; measured within 3.4e-6). bf16: a relative norm of 2e-2
# against the reference as it runs (ViT's and ConvNeXt's layers under
# ``lax.scan``), 1e-2 against ``scan_layers=False``, op for op as the
# port: measured 0 at two of three seeds and 3.1e-3 at the third (a bf16
# product summed in another order flips a last bit), in both
# ---------------------------------------------------------------------------

ATOL = 1e-5


def _bridged(arch, dtype="float32", seed=0, scan=True):
    jcfg = dataclasses.replace(jreduced(jget(arch)), param_dtype=dtype, scan_layers=scan)
    cfg = dataclasses.replace(reduced(get_config(arch)), param_dtype=dtype)
    jmod, mod = MODULES[cfg.kind]
    jp = jmod.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, mod.from_numpy(jp, device="cpu")


def _images(seed, b, res):
    return np.random.default_rng(seed).standard_normal((b, res, res, 3)).astype(np.float32)


def _forward_pair(arch, dtype, seed=0, scan=True, b=4, res=None):
    """(port logits, reference logits) of one batch of seeded images."""
    jcfg, jp, cfg, p = _bridged(arch, dtype, seed, scan)
    jmod, mod = MODULES[cfg.kind]
    img = _images(seed + 10, b, res or cfg.img_res)
    if cfg.kind == "resnet":
        return (mod.forward(*p, cfg, torch.from_numpy(img))[0],
                jmod.forward(*jp, jcfg, jnp.asarray(img))[0])
    return mod.forward(p, cfg, torch.from_numpy(img)), jmod.forward(jp, jcfg, jnp.asarray(img))


@pytest.mark.parametrize("arch", VISION_ARCHS)
def test_forward_matches_reference_in_float32(arch):
    got, want = _forward_pair(arch, "float32")
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
@pytest.mark.parametrize("arch", VISION_ARCHS)
def test_forward_matches_reference_in_bf16(arch, scan):
    for seed in range(2):
        got, want = _forward_pair(arch, "bfloat16", seed, scan)
        assert got.dtype == torch.float32
        got, want = got.numpy(), np.asarray(want)
        assert np.linalg.norm(got - want) <= (2e-2 if scan else 1e-2) * np.linalg.norm(want)


@pytest.mark.parametrize("arch", ["vit-h14", "convnext-b"])
def test_block_bf16_rounds_as_reference(arch):
    """One bf16 block of the reference run eagerly, op for op, and the
    port's agree as ``_assert_bf16_rounds_as`` demands: LayerNorm, the
    products, GELU, the residuals (ViT's attention in the plain version;
    ConvNeXt's depthwise conv and layer scale)."""
    jcfg, jp, cfg, p = _bridged(arch, "bfloat16", seed=2)
    rng = np.random.default_rng(2)
    if cfg.kind == "vit":
        x = rng.standard_normal((2, 17, cfg.d_model)).astype(np.float32)
        jblock = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
        want = jvit._block(jblock, jcfg, jnp.asarray(x, jnp.bfloat16))
        got = vit._block({k: a[0] for k, a in p["blocks"].items()}, cfg,
                         torch.from_numpy(x).bfloat16())
    else:
        x = rng.standard_normal((2, 8, 8, cfg.dims[0])).astype(np.float32)
        # gamma 1e-6 hides the branch: give it weight
        jblock = jax.tree_util.tree_map(lambda a: a[0], jp["stages"][0])
        jblock["gamma"] = jnp.full_like(jblock["gamma"], 0.5)
        want = jconvnext._block(jblock, jnp.asarray(x, jnp.bfloat16))
        block = {k: a[0] for k, a in p["stages"][0].items()}
        block["gamma"] = torch.full_like(block["gamma"], 0.5)
        got = convnext._block(block, torch.from_numpy(x).bfloat16())
    _assert_bf16_rounds_as(got, want)


def test_vit_resizes_position_embeddings_at_another_resolution():
    """At twice init's resolution (64 px: 8 x 8 patches against init's
    4 x 4, the ``cls_384`` case) the position grid is resized bilinearly
    as ``jax.image.resize`` does; atol 1e-5 in float32."""
    for arch in ("vit-l16", "vit-h14"):
        got, want = _forward_pair(arch, "float32", b=2, res=64)
        assert tuple(got.shape) == (2, 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    jcfg, jp, cfg, p = _bridged("vit-l16")
    img = _images(5, 2, 64)
    x = vit.embed(p, cfg, torch.from_numpy(img))
    assert tuple(x.shape) == (2, 65, cfg.d_model)


def test_resnet_train_updates_running_statistics():
    """``train=True``: logits on the batch statistics and every running
    (mean, var) leaf updated with momentum 0.9, within 1e-5 of the
    reference's; then eval from the updated state, within 1e-5. Batch 4:
    at 32 px the last stage is 1 x 1, so its BatchNorm normalizes over
    the batch alone, and over 2 values a one-ulp difference in either is
    divided by their distance (2.8e-5 measured at batch 2)."""
    jcfg, (jparams, jstate), cfg, (params, state) = _bridged("resnet-152")
    img = _images(7, 4, cfg.img_res)
    got, new = resnet.forward(params, state, cfg, torch.from_numpy(img), train=True)
    want, jnew = jresnet.forward(jparams, jstate, jcfg, jnp.asarray(img), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    paths, leaves = tree.flatten_with_paths(new)
    jleaves = _jpaths(jnew)
    assert paths == [p for p, _ in jleaves] and len(paths) == 2 * (1 + 4 * 3 + 4)
    for path, t, (_, j) in zip(paths, leaves, jleaves):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, err_msg=path)
    assert not torch.equal(new["stages"][3][0]["bn3"]["mean"], state["stages"][3][0]["bn3"]["mean"])
    img2 = _images(8, 4, cfg.img_res)
    got2, same = resnet.forward(params, new, cfg, torch.from_numpy(img2))
    want2, _ = jresnet.forward(jparams, jnew, jcfg, jnp.asarray(img2))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=ATOL)
    assert all(a is b for a, b in zip(tree.leaves(same), tree.leaves(new)))
