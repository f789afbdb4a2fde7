"""Parameter sharding rules: parameter-tree path patterns -> a spec.

Counterpart of ``repro/sharding/rules.py``, table for table: tensor
parallelism over the "model" axis (column- and row-parallel products,
expert parallelism for MoE, output channels for convolutions),
everything small (norms, routers, biases) replicated. A rule is a regex
searched in the '/'-joined tree path (:func:`repro_torch.tree.flatten_with_paths`,
the reference's ``_path_str``); the first match wins, and no match
replicates.
"""
from __future__ import annotations

import re
from typing import List, Tuple

from repro_torch import tree as T
from repro_torch.sharding import P, axis_sizes, entry_axes

Rules = List[Tuple[str, P]]

# stacked LM blocks carry a leading layer dim -> the specs below include it
LM_RULES: Rules = [
    (r"embed$", P("model", None)),
    (r"lm_head$", P(None, "model")),
    # GQA attention
    (r"attn/w[qkv]$", P(None, None, "model")),
    (r"attn/wo$", P(None, "model", None)),
    # MLA
    (r"attn/w_dkv$", P(None, None, None)),
    (r"attn/w_u[kv]$", P(None, None, "model")),
    # dense FFN
    (r"mlp/w_(gate|up)$", P(None, None, "model")),
    (r"mlp/w_down$", P(None, "model", None)),
    # MoE: experts sharded over the model axis (EP)
    (r"moe/w_(gate|up)$", P(None, "model", None, None)),
    (r"moe/w_down$", P(None, "model", None, None)),
    (r"moe/shared/w_(gate|up)$", P(None, None, "model")),
    (r"moe/shared/w_down$", P(None, "model", None)),
]

VIT_RULES: Rules = [
    (r"patch_w$", P(None, None, None, "model")),
    (r"blocks/wqkv$", P(None, None, "model")),
    (r"blocks/wo$", P(None, "model", None)),
    (r"blocks/w_in$", P(None, None, "model")),
    (r"blocks/w_out$", P(None, "model", None)),
    (r"head$", P(None, "model")),
]

CONVNEXT_RULES: Rules = [
    (r"stem_w$", P(None, None, None, "model")),
    (r"stages/\d+/pw1$", P(None, None, "model")),
    (r"stages/\d+/pw2$", P(None, "model", None)),
    (r"downs/\d+/w$", P(None, None, None, "model")),
    (r"head$", P(None, "model")),
]

RESNET_RULES: Rules = [
    (r"w[123]$", P(None, None, None, "model")),
    (r"proj_w$", P(None, None, None, "model")),
    (r"stem_w$", P(None, None, None, "model")),
    (r"head$", P("model", None)),
]

DIT_RULES: Rules = [
    (r"blocks/wqkv$", P(None, None, "model")),
    (r"blocks/wo$", P(None, "model", None)),
    (r"blocks/w_in$", P(None, None, "model")),
    (r"blocks/w_out$", P(None, "model", None)),
    (r"blocks/ada_w$", P(None, None, "model")),
    (r"y_emb$", P("model", None)),
]

UNET_RULES: Rules = [
    (r"/w[12]$", P(None, None, None, "model")),
    (r"skip_w$", P(None, None, None, "model")),
    (r"(down|up)_w$", P(None, None, None, "model")),
    (r"sa_qkv$", P(None, "model")),
    (r"sa_o$", P("model", None)),
    (r"ca_[qkv]$", P(None, "model")),
    (r"ca_o$", P("model", None)),
    (r"ff_in$", P(None, "model")),
    (r"ff_out$", P("model", None)),
    (r"proj_(in|out)$", P(None, "model")),
    (r"temb_w$", P(None, "model")),
]

DETECTOR_RULES: Rules = [
    (r"stem$", P(None, None, None, "model")),
    (r"stages/\d+/\d+/w$", P(None, None, None, "model")),
    (r"head_w$", P(None, None, "model", None)),
]


def rules_for(cfg) -> Rules:
    fam = cfg.family
    if fam == "lm":
        return LM_RULES
    if fam == "vision":
        return {"vit": VIT_RULES, "convnext": CONVNEXT_RULES,
                "resnet": RESNET_RULES}[cfg.kind]
    if fam == "diffusion":
        return DIT_RULES if cfg.kind == "dit" else UNET_RULES
    if fam == "detector":
        return DETECTOR_RULES
    raise KeyError(fam)


def spec_for_path(path_str: str, ndim: int, rules: Rules) -> P:
    for pat, spec in rules:
        if re.search(pat, path_str):
            if len(spec) == ndim:
                return spec
            # rank mismatch (an unstacked leaf against a stacked rule): right-align
            if len(spec) < ndim:
                return P(*([None] * (ndim - len(spec)) + list(spec)))
            return P(*list(spec)[len(spec) - ndim:])
    return P(*([None] * ndim))


def sanitize_spec(spec: P, shape, mesh) -> P:
    """Drop the spec's axes whose mesh size does not divide the dim (an
    input's layout must divide evenly; such a dim is replicated)."""
    sizes = axis_sizes(mesh)
    parts = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            parts.append(None)
            continue
        n = 1
        for a in entry_axes(ax):
            n *= sizes.get(a, 1)
        parts.append(ax if dim % n == 0 else None)
    return P(*parts)


def param_specs(params, cfg, mesh=None):
    """A tree of :class:`P` shaped like ``params`` (sanitized for
    ``mesh`` when one is given)."""
    rules = rules_for(cfg)
    paths, leaves = T.flatten_with_paths(params)
    specs = []
    for path, leaf in zip(paths, leaves):
        s = spec_for_path(path, leaf.ndim, rules)
        specs.append(sanitize_spec(s, leaf.shape, mesh) if mesh is not None else s)
    return T.unflatten(params, specs)


def param_shardings(params, mesh, cfg):
    """``params`` placed on ``mesh`` by :func:`param_specs`: a tree of
    DTensors (``distribute_tensor`` of each leaf, from this rank's copy)."""
    from repro_torch.sharding.place import distribute
    return distribute(params, param_specs(params, cfg, mesh), mesh)
