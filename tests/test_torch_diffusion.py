"""The port's diffusion serving path against the reference, on the CPU.

The same inputs, made from a seed with numpy, go through ``repro`` and
``repro_torch``: the configs, shape sets and registry (``list_archs``,
``ASSIGNED_ARCHS``, the 40 cells of ``all_cells``), the DDIM timestep
table, the noise schedule, ``add_noise`` and ``ddim_step``, the init
layout of DiT and the UNet, and ``forward`` and a 4-step ``sample`` of
reduced DiT-S/2 and SD-1.5 UNet from the reference's own seeded weights
carried over by ``tree.from_numpy``.

``init`` zeroes DiT's adaLN-Zero leaves, so a forward from it returns
exactly 0 whatever the blocks compute: a parity check on it checks
nothing. Every forward here first sets those leaves, in both trees, to
the same seeded nonzero values, and asserts a nonzero output. The
attention on the card is the ``flash_attention`` kernel's tensor-core
entry (heads of 64), which ``chip_smoke.py`` phase 14 runs; its
diffusion shapes are emulated in ``test_torch_flash_route.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import diffusion as jdiffusion
from repro.models import dit as jdit
from repro.models import unet as junet
from repro_torch import configs, tree
from repro_torch.configs import get_config, reduced, to_dict
from repro_torch.models import diffusion, dit, unet

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

DIFFUSION_ARCHS = ("dit-s2", "unet-sd15")
MODULES = {"dit": (jdit, dit), "unet": (junet, unet)}


def _jpaths(tree_):
    """The reference tree's (path, leaf) in JAX's order, paths joined
    with "/" as ``repro_torch.tree`` joins them."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return [("/".join(key(k) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree_)[0]]


# ---------------------------------------------------------------------------
# configs, shape sets, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DIFFUSION_ARCHS)
def test_configs_match_reference(arch):
    """Fields as dicts (the port leaves out the reference's
    ``scan_layers``: its layers run in a loop; ``remat`` is kept),
    ``n_params``, of the config and of ``reduced``."""
    for c, j in ((get_config(arch), jget(arch)), (reduced(get_config(arch)), jreduced(jget(arch)))):
        got, want = to_dict(c), jbase.to_dict(j)
        assert set(want) - set(got) == {"scan_layers"}
        assert got == {k: want[k] for k in got}
        assert c.n_params == j.n_params


def test_config_modules_name_their_sources():
    from repro_torch.configs import dit_s2, unet_sd15
    assert "arXiv:2212.09748" in dit_s2.__doc__
    assert "arXiv:2112.10752" in unet_sd15.__doc__


def test_registry_matches_reference():
    """``list_archs`` and ``ASSIGNED_ARCHS`` in the reference's order, the
    40 (arch, shape) cells of ``all_cells``, and every family's shape set
    (``FAMILY_SHAPES`` gains "diffusion")."""
    assert configs.list_archs() == jbase.list_archs()
    assert configs.ASSIGNED_ARCHS == jbase.ASSIGNED_ARCHS
    assert configs.all_cells() == jbase.all_cells() and len(configs.all_cells()) == 40
    assert set(configs.FAMILY_SHAPES) == set(jbase.FAMILY_SHAPES)
    for family, shapes in jbase.FAMILY_SHAPES.items():
        assert [dataclasses.astuple(s) for s in configs.FAMILY_SHAPES[family]] == \
            [dataclasses.astuple(s) for s in shapes]
    for arch in configs.list_archs():
        assert get_config(arch).family == jget(arch).family
    assert [s.name for s in configs.get_shapes("unet-sd15")] == \
        ["train_256", "gen_1024", "gen_fast", "train_1024"]
    assert configs.get_shape("dit-s2", "gen_fast") == configs.DIFFUSION_SHAPES[2]


# ---------------------------------------------------------------------------
# the sampler's arithmetic: the timestep table and the schedule bit for
# bit; add_noise and one DDIM step within 1e-6 relative (XLA's CPU
# program may contract a product and a sum into one fma, and torch
# divides by a host scalar through its reciprocal)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_steps", list(range(1, 65)) + [1000])
def test_timesteps_match_reference(n_steps):
    want = np.asarray(jnp.linspace(jdiffusion.N_TRAIN_STEPS - 1, 0, n_steps + 1)
                      .astype(jnp.int32))
    assert diffusion.timesteps(n_steps) == want.tolist()


def test_timesteps_truncate_as_jax_does():
    """JAX's float32 formula gives 665.99994 for n_steps 3, truncated to
    665, where ``torch.linspace`` gives 666."""
    assert diffusion.timesteps(3) == [999, 665, 332, 0]
    assert int(torch.linspace(999, 0, 4)[1].to(torch.int32)) == 666


def test_alphas_cumprod_matches_reference_bit_for_bit():
    """glibc's ``cosf`` (XLA's CPU ``cos``) gives the reference's table;
    ``torch.cos`` differs in the last bit of some entries."""
    got = diffusion.alphas_cumprod()
    want = np.asarray(jdiffusion.alphas_cumprod())
    assert got.dtype == torch.float32 and got.shape == (1000,)
    np.testing.assert_array_equal(got.numpy(), want)
    t = torch.arange(1001, dtype=torch.float32) / 1000
    naive = torch.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    assert not np.array_equal(torch.clamp(naive / naive[0], 1e-5, 1.0)[1:].numpy(), want)


def _latents(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_add_noise_matches_reference():
    x, noise = _latents(0, (5, 4, 4, 4)), _latents(1, (5, 4, 4, 4))
    t = np.array([0, 1, 500, 998, 999], np.int32)
    got = diffusion.add_noise(*map(torch.from_numpy, (x, noise, t)))
    want = np.asarray(jdiffusion.add_noise(x, noise, t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t_cur,t_prev", [(999, 665), (665, 333), (333, 0), (20, 0), (5, -1)])
def test_ddim_step_matches_reference(t_cur, t_prev):
    """With a plain eps_fn of x and t, as both sides compute it."""
    x = _latents(2, (3, 4, 4, 4))

    def eps(x, t, xp):
        return 0.7 * x + xp.reshape(t, (-1, 1, 1, 1)) / 1000.0

    got = diffusion.ddim_step(lambda x, t: eps(x, t.float(), torch), torch.from_numpy(x),
                              t_cur, t_prev)
    want = np.asarray(jdiffusion.ddim_step(lambda x, t: eps(x, t.astype(jnp.float32), jnp),
                                           jnp.asarray(x), t_cur, t_prev))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# init and the weight bridge
# ---------------------------------------------------------------------------

def _init(mod, cfg, seed=0):
    return mod.init(torch.Generator().manual_seed(seed), cfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DIFFUSION_ARCHS)
def test_init_has_the_reference_layout(arch, dtype):
    """Paths, shapes and dtypes of every leaf equal the reference's, in
    JAX's leaf order (the UNet's stages and blocks are lists)."""
    cfg = dataclasses.replace(reduced(get_config(arch)), param_dtype=dtype)
    jcfg = dataclasses.replace(jreduced(jget(arch)), param_dtype=dtype)
    jmod, mod = MODULES[cfg.kind]
    jp = jax.eval_shape(lambda key: jmod.init(key, jcfg), jax.random.PRNGKey(0))
    paths, leaves = tree.flatten_with_paths(_init(mod, cfg))
    want = _jpaths(jp)
    assert paths == [p for p, _ in want]
    for path, t, (_, j) in zip(paths, leaves, want):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype), path


def test_dit_init_zeroes_the_adaln_leaves_and_draws_the_rest():
    cfg = dataclasses.replace(reduced(get_config("dit-s2")), d_model=256, n_heads=4)
    p = _init(dit, cfg)
    block_leaves, top_leaves = dit.ADALN_ZERO
    assert all(bool((p["blocks"][k] == 0).all()) for k in block_leaves)
    assert all(bool((p[k] == 0).all()) for k in top_leaves)
    assert abs(p["blocks"]["wqkv"].std().item() - 0.88 / 256 ** 0.5) < 0.01  # ±2σ cut
    assert abs(p["y_emb"].std().item() - 0.88 * 0.02) < 0.002


def test_from_numpy_carries_bf16_exactly():
    jcfg = dataclasses.replace(jreduced(jget("unet-sd15")), param_dtype="bfloat16")
    jp = jax.jit(junet.init, static_argnums=(1,))(jax.random.PRNGKey(1), jcfg)
    got = unet.from_numpy(jp, device="cpu")
    assert isinstance(got["down"], list) and isinstance(got["up"][0]["blocks"], list)
    for (path, t), (_, j) in zip(zip(*tree.flatten_with_paths(got)), _jpaths(jp)):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card (``torch.cuda.is_available`` patched, so the test
    means the same on a machine with one) ``init`` and ``from_numpy``
    raise unless the caller passes ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in DIFFUSION_ARCHS:
        cfg = reduced(get_config(arch))
        mod = MODULES[cfg.kind][1]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.init(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.from_numpy(_init(mod, cfg))


def test_upsample_is_jax_nearest_resize():
    x = _latents(3, (2, 5, 6, 3))
    want = np.asarray(jax.image.resize(x, (2, 10, 12, 3), "nearest"))
    np.testing.assert_array_equal(unet.upsample2x(torch.from_numpy(x)).numpy(), want)


# ---------------------------------------------------------------------------
# forward and sample from bridged weights. float32: atol 1e-5 (float32
# sums in another order; measured 3.5e-6 to 4.1e-6 on outputs up to 3.8).
# bf16: relative norms (below). The 4-step sample: the first DDIM step
# divides by sqrt(a_999) = 3.2e-3, so the samples are held at a relative
# norm of 1e-4
# ---------------------------------------------------------------------------

ATOL = 1e-5
SAMPLE_RTOL = 1e-4
N_SAMPLE_STEPS = 4


def _nonzero_adaln(jp, seed):
    """DiT's adaLN-Zero leaves set to seeded values: weights at fan-in
    scale, biases at 0.1 (in the tree's dtype)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        scale = 0.1 if a.ndim == 1 else 1.0 / np.sqrt(a.shape[-2])
        return jnp.asarray(rng.standard_normal(a.shape) * scale, a.dtype)
    block_leaves, top_leaves = dit.ADALN_ZERO
    jp = dict(jp, blocks=dict(jp["blocks"]))
    for k in block_leaves:
        jp["blocks"][k] = draw(jp["blocks"][k])
    for k in top_leaves:
        jp[k] = draw(jp[k])
    return jp


def _bridged(arch, dtype="float32", seed=0, scan=True):
    jcfg = dataclasses.replace(jreduced(jget(arch)), param_dtype=dtype, scan_layers=scan)
    cfg = dataclasses.replace(reduced(get_config(arch)), param_dtype=dtype)
    jmod, mod = MODULES[cfg.kind]
    jp = jmod.init(jax.random.PRNGKey(seed), jcfg)
    if cfg.kind == "dit":
        jp = _nonzero_adaln(jp, seed + 100)
    return jcfg, jp, cfg, mod.from_numpy(jp, device="cpu")


def _inputs(cfg, seed, b):
    """(latents (B, Hl, Wl, 4) at twice the reduced config's latent side
    for DiT (16 tokens), timesteps, class ids or a text context)."""
    rng = np.random.default_rng(seed)
    side = 2 * dit.latent_res(cfg) if cfg.kind == "dit" else dit.latent_res(cfg)
    lat = rng.standard_normal((b, side, side, cfg.latent_ch)).astype(np.float32)
    t = np.array([0, 500, 999, 250][:b], np.int32)
    if cfg.kind == "dit":
        cond = np.array([0, 3, cfg.n_classes, 7][:b], np.int32)   # n_classes: the null class
    else:
        cond = rng.standard_normal((b, cfg.ctx_len, cfg.ctx_dim)).astype(np.float32)
    return lat, t, cond


@functools.lru_cache(maxsize=None)
def _jit_forward(kind):
    return jax.jit(MODULES[kind][0].forward, static_argnums=(1,))


def _eps(out):
    return out[0] if isinstance(out, tuple) else out


def _forward_pair(arch, dtype, seed=0, scan=True, b=3, jit=True):
    """(port eps, reference eps) of one seeded batch; DiT also sigma."""
    jcfg, jp, cfg, p = _bridged(arch, dtype, seed, scan)
    lat, t, cond = _inputs(cfg, seed + 10, b)
    mod = MODULES[cfg.kind][1]
    got = mod.forward(p, cfg, *map(torch.from_numpy, (lat, t, cond)))
    jfwd = _jit_forward(cfg.kind) if jit else MODULES[cfg.kind][0].forward
    want = jfwd(jp, jcfg, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(cond))
    return got, want


@pytest.mark.parametrize("arch", DIFFUSION_ARCHS)
def test_forward_matches_reference_in_float32(arch):
    got, want = _forward_pair(arch, "float32")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == (2 if arch == "dit-s2" else 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert np.abs(w).max() > 0.1     # not the zero output of adaLN-Zero
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


@pytest.mark.parametrize("arch,scan", [("dit-s2", True), ("dit-s2", False),
                                       ("unet-sd15", False)],
                         ids=["dit-scanned", "dit-unrolled", "unet"])
def test_forward_matches_reference_in_bf16(arch, scan):
    """Against the reference run eagerly, op by op as the port (jitted,
    XLA keeps fused bf16 elementwise chains in float32: 5e-3 to 1.8e-2
    off). Measured: DiT unrolled 0 and 7.6e-4, scanned 5.1e-3 to
    6.1e-3; the UNet 0 and 8.0e-3 (a bf16 product summed in another
    order flips a last bit, and the norms carry it on)."""
    limit = 1e-2 if arch == "dit-s2" and not scan else 2e-2
    for seed in range(2):
        got, want = _forward_pair(arch, "bfloat16", seed, scan, jit=False)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            assert np.abs(w).max() > 0.1
            assert np.linalg.norm(g - w) <= limit * np.linalg.norm(w)


def test_dit_block_bf16_rounds_as_reference():
    """One bf16 block of the reference run eagerly, op for op, and the
    port's (attention in the plain version) round alike: 99% of the
    values bit for bit, the rest within one bf16 ulp."""
    jcfg, jp, cfg, p = _bridged("dit-s2", "bfloat16", seed=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    cond = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    jblock = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    want = np.asarray(jdit._block(jblock, jcfg, jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(cond, jnp.bfloat16)), np.float32)
    got = dit._block({k: a[0] for k, a in p["blocks"].items()}, cfg,
                     torch.from_numpy(x).bfloat16(), torch.from_numpy(cond).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - x).max() > 0.1     # the gated branches add something
    assert np.mean(got == want) >= 0.99
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))


@pytest.mark.parametrize("arch", DIFFUSION_ARCHS)
def test_sample_matches_reference(arch):
    """A 4-step DDIM sample in float32 from the reference's own starting
    noise (``jax.random.normal`` of its key), the reference scanning its
    steps, the port looping them."""
    jcfg, jp, cfg, p = _bridged(arch, "float32", seed=3)
    lat, _, cond = _inputs(cfg, 13, 2)
    key = jax.random.PRNGKey(7)
    jmod, mod = MODULES[cfg.kind]

    def jeps(params, x, t):
        return _eps(jmod.forward(params, jcfg, x, t, jnp.asarray(cond)))

    want = np.asarray(jax.jit(lambda params: jdiffusion.sample(
        lambda x, t: jeps(params, x, t), key, lat.shape, N_SAMPLE_STEPS))(jp))
    noise = np.array(jax.random.normal(key, lat.shape, jnp.float32))
    cond_t = torch.from_numpy(cond)
    got = diffusion.sample(lambda x, t: _eps(mod.forward(p, cfg, x, t, cond_t)),
                           torch.from_numpy(noise), N_SAMPLE_STEPS)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(want - noise).max() > 0.1
    assert np.linalg.norm(got.numpy() - want) <= SAMPLE_RTOL * np.linalg.norm(want)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 14 bookkeeping, on the CPU: the FLOP count of its
# bound and the flash launches it expects a forward
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", DIFFUSION_ARCHS)
def test_chip_smoke_counts_the_references_flops(arch):
    """chip_smoke's phase 14 bound, ``launch.steps``' ``_dit_fwd_flops`` /
    ``_unet_fwd_flops``, is the reference's (repro/launch/steps.py) at
    every gen and train resolution."""
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps
    jfn = jsteps._dit_fwd_flops if arch == "dit-s2" else jsteps._unet_fwd_flops
    fn = steps._dit_fwd_flops if arch == "dit-s2" else steps._unet_fwd_flops
    for res in (256, 512, 1024):
        assert fn(get_config(arch), res) == pytest.approx(jfn(jget(arch), res), rel=1e-12)


@pytest.mark.parametrize("arch", DIFFUSION_ARCHS)
def test_chip_smoke_expects_one_flash_launch_per_attention_call(arch):
    """The reduced models' forward calls ``ops.attention`` as often as
    ``diffusion_flash_per_forward`` says (DiT: a layer; the UNet: a
    self- and a cross-attention a transformer block), and the full-width
    counts are phase 14's 12 and 32."""
    cs = _chip_smoke()
    jcfg, jp, cfg, p = _bridged(arch)
    lat, t, cond = _inputs(cfg, 20, 2)
    calls = cs.attention_shapes(lambda: MODULES[cfg.kind][1].forward(
        p, cfg, *map(torch.from_numpy, (lat, t, cond))))
    assert len(calls) == cs.diffusion_flash_per_forward(cfg)
    assert cs.diffusion_flash_per_forward(get_config(arch)) == (12 if arch == "dit-s2" else 32)
