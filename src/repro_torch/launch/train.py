"""LM training entry point of the port, under the fault-tolerant
supervisor (counterpart of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --steps 20

Always the reduced config, as the reference's (``--reduced`` is on and
cannot be turned off); seeded weights (``lm.init`` from a generator seeded
0), seeded tokens with ``labels = roll(tokens, -1)`` as the reference's
``data_fn``; AdamW with ``cosine_with_warmup(lr, 10, steps)``; a checkpoint
every ``--ckpt-every`` steps into ``--ckpt-dir`` (by default
``artifacts/lm_train_torch`` in the checkout), and a run over a directory
that holds one resumes from its latest step; ``--compress`` sends each
gradient through the int8 codec (``optim/compress.py``), what the wire
would see under compressed data parallelism. Runs on the card unless
``--device cpu``. ``build_lm_trainer`` takes the reference's mesh: the
state laid out by ``sharding.rules.param_shardings`` (:func:`place_state`),
the batch over the data axes.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import lm
from repro_torch.optim.adamw import adamw
from repro_torch.optim.compress import int8_roundtrip_tree
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.runtime.supervisor import SupervisorConfig, run_training

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "artifacts", "lm_train_torch")


def place_state(params, cfg, mesh):
    """``params`` laid out on ``mesh`` by the rules
    (``sharding.rules.param_shardings``): the state a mesh trainer takes.
    Every rank passes the same values (each keeps its own shards)."""
    from repro_torch.sharding.place import distribute
    from repro_torch.sharding.rules import param_specs
    return distribute(params, param_specs(params, cfg, mesh), mesh, src_data_rank=None)


def build_lm_trainer(cfg, mesh=None, lr: float = 3e-4, total_steps: int = 100,
                     compress: bool = False, device="cuda"):
    """-> (step_fn, opt_init), the reference's ``build_lm_trainer``:
    ``step_fn(state, batch) -> (state, loss)`` for
    ``run_training``, ``state = (params, opt_state, rng)`` with ``rng`` a
    ``torch.Generator``'s state (a uint8 tensor, so it is checkpointed
    with the rest; the compression's uniforms come from it, as the
    reference splits its key), ``batch = (tokens, labels)`` (B, S)
    integers (numpy or tensors), moved to ``device``. The update is
    functional: a step whose loss is not finite is dropped by the
    supervisor and the old state kept.

    On a ``mesh`` (a ``DeviceMesh`` with named dims) the parameters are
    DTensors laid out by :func:`place_state`, ``opt_init`` lays the
    moments out as the parameters, and each step puts its batch's rows
    over the data axes (``sharding.policy.lm_specs``) and runs with the
    mesh active, on the mesh's device type. ``compress`` draws one
    uniform a gradient element from ``rng``, the whole leaf's on every
    rank of a mesh, so a sharded gradient's round trip is the one-device
    round trip of the same values (:mod:`repro_torch.optim.compress`)."""
    device = resolve_device(device if mesh is None else mesh.device_type)
    opt_init, opt_update = adamw(cosine_with_warmup(lr, 10, total_steps))

    def grads_of(params, tokens, labels):
        if mesh is None:
            return value_and_grad(lambda p: lm.loss_fn(p, cfg, tokens, labels), params)[:2]
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.sharding import ctx, policy
        from repro_torch.sharding.place import distribute
        spec = policy.lm_specs(mesh, "train", *tokens.shape)["tokens"]
        tokens, labels = distribute((tokens, labels), spec, mesh, src_data_rank=None)
        with ctx.use_mesh(mesh), implicit_replication():
            return value_and_grad(lambda p: lm.loss_fn(p, cfg, tokens, labels), params)[:2]

    def step_fn(state, batch):
        params, opt_state, rng = state
        tokens, labels = (torch.as_tensor(np.asarray(x)).to(device) for x in batch)
        loss, grads = grads_of(params, tokens, labels)
        if compress:
            gen = torch.Generator(device=device)
            gen.set_state(rng)
            grads = int8_roundtrip_tree(grads, gen)
            rng = gen.get_state()
        params, opt_state, _ = opt_update(grads, opt_state, params)
        if mesh is not None:
            loss = loss.full_tensor()
        return (params, opt_state, rng), loss

    return step_fn, opt_init


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family != "lm":
        raise SystemExit("train.py drives LM archs; see examples/ for others")

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init(gen, cfg, device=device)
    step_fn, opt_init = build_lm_trainer(cfg, total_steps=args.steps, compress=args.compress,
                                         device=device)
    state = (params, opt_init(params), gen.get_state())

    rng = np.random.default_rng(0)

    def data_fn(step):
        tokens = rng.integers(0, cfg.vocab_size, (args.batch, args.seq), dtype=np.int32)
        labels = np.roll(tokens, -1, axis=1)
        return tokens, labels

    sup = SupervisorConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                           max_steps=args.steps)
    state, report = run_training(state, step_fn, data_fn, sup)
    losses = report.losses or [float("nan")]   # nan: resumed at the last step, none run
    print(f"steps={report.steps_run} resumed_from={report.resumed_from} "
          f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f} "
          f"rejected={report.rejected_steps}")
    return report


if __name__ == "__main__":
    main()
