"""Import reference PyTorch checkpoints into the port's nets.

Port of inverseproblemwithdiffusionmodel_tpu/utils/torch_import.py. The
reference trains its score nets with PyTorch Lightning and stores the EMA
weights inside the checkpoint under ``callbacks.EMA.ema_state_dict`` with a
``model.`` key prefix (helpers/pl_callbacks.py:110-121,
helpers/utils.py:161-170). This module fills the port's NCSNv2 family (2-D
``NCSNv2/Deeper/Deepest`` and the 1-D and 3-D nets), NCSN++, DDPM and NCSN
v1 from such a state dict.

The conversion is *template driven*, as the JAX package's is: the template
is the port's own ``nn.Module`` (built by ``models/registry``), and every
entry of its ``state_dict`` is filled from the reference's (a missing key,
a shape mismatch or, with ``strict_unused``, an unconsumed reference weight
raises). The result is that module's state dict, ready for
``load_state_dict``.

The port keeps the Flax module names (utils/convert.py), so the conversion
runs in two steps. First the reference key -> Flax path grammar below (the
JAX package's, copied: numpy only) fills the Flax layout of the template:
conv ``(O, I, *k)`` -> ``(*k, I, O)``, ``Sequential`` / ``ModuleList``
indices -> the Flax submodule names, InstanceNorm++ ``alpha/gamma/beta``
unchanged. Then ``utils/convert.flax_to_torch`` maps that Flax tree onto
the port's state dict, as it maps the JAX package's parameters. The Flax
layout of the template is the inverse of that map (``flax_layout``), held
to it entry by entry.

No reference code is imported or copied; the key grammar is derived from
the reference's module attribute structure.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from . import convert

Path = Tuple[str, ...]


# ---------------------------------------------------------------------------
# state-dict plumbing
# ---------------------------------------------------------------------------

def collate_state_dict(state_dict: Dict[str, Any],
                       prefix: str = "model.") -> Dict[str, Any]:
    """Strip a submodule prefix from every key (reference:
    helpers/utils.py:161-170 strips the Lightning ``model.`` wrapper)."""
    out = {}
    for k, v in state_dict.items():
        out[k[len(prefix):] if k.startswith(prefix) else k] = v
    return out


def extract_ema_state_dict(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """Pull the EMA weights out of a Lightning checkpoint dict, falling
    back to the raw ``state_dict`` (reference: helpers/load_model.py:179-186
    prefers ``ckpt["callbacks"]["EMA"]["ema_state_dict"]``)."""
    cb = ckpt.get("callbacks", {})
    if isinstance(cb, dict):
        ema = cb.get("EMA", {})
        if isinstance(ema, dict) and "ema_state_dict" in ema:
            return collate_state_dict(ema["ema_state_dict"])
    if "state_dict" in ckpt:
        return collate_state_dict(ckpt["state_dict"])
    # already a bare state dict
    return collate_state_dict(ckpt)


def load_torch_checkpoint(path: str, use_ema: bool = True
                          ) -> Dict[str, np.ndarray]:
    """``torch.load`` a reference checkpoint (PL ``.ckpt`` or a bare
    ``state_dict`` ``.pth``) and return a flat {key: np.ndarray} dict.
    Lightning checkpoints hold more than tensors, hence
    ``weights_only=False``: load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = extract_ema_state_dict(ckpt) if use_ema else collate_state_dict(
        ckpt.get("state_dict", ckpt))
    return {k: np.asarray(v.detach().cpu().numpy()
                          if hasattr(v, "detach") else v)
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# the template's Flax layout (the inverse of utils/convert.flax_to_torch)
# ---------------------------------------------------------------------------

def flax_layout(model: nn.Module) -> Dict[Path, np.ndarray]:
    """The model's state dict in the JAX package's Flax layout, by Flax
    path: convolution weights (O, I, *k) -> kernel (*k, I, O), transposed
    ones (I, O, *k) -> (*k, I, O), Linear (out, in) -> kernel (in, out),
    1-D weights (GroupNorm, BatchNorm) -> scale, everything else as it is.
    Each entry is held to utils/convert's map back (raises on a
    difference)."""
    transposed = {name for name, module in model.named_modules()
                  if isinstance(module, convert._TRANSPOSED)}
    out = {}
    for key, value in model.state_dict().items():
        module, dot, leaf = key.rpartition(".")
        arr = value.detach().cpu().numpy()
        if leaf == "weight" and arr.ndim >= 3:
            n = arr.ndim
            spatial = tuple(range(2, n))
            arr = arr.transpose(spatial + ((0, 1) if module in transposed
                                           else (1, 0)))
            leaf = "kernel"
        elif leaf == "weight" and arr.ndim == 2:
            arr, leaf = arr.T, "kernel"
        elif leaf == "weight":
            leaf = "scale"
        path = tuple(module.split(".")) + (leaf,) if dot else (leaf,)
        back, back_arr = convert._convert_leaf(".".join(path), arr,
                                               transposed)
        if back != key or back_arr.shape != tuple(value.shape):
            raise AssertionError(f"{key}: Flax layout {path} maps back to "
                                 f"{back} {back_arr.shape}")
        out[path] = arr
    return out


def _to_port(flat: Dict[Path, np.ndarray], model: nn.Module, what: str
             ) -> Dict[str, torch.Tensor]:
    """The model's state dict from a filled Flax-layout tree, through
    utils/convert's map, held name by name and shape by shape to the
    model; raises on any difference."""
    return convert._checked(_unflatten(flat), lambda: model, what)


# ---------------------------------------------------------------------------
# flax-path -> torch-key grammar (NCSNv2 family)
# ---------------------------------------------------------------------------

_RES_RE = re.compile(r"^res(\w+)_(\d+)$")       # res1_0 -> ("1", "0")
_CONV_RE = re.compile(r"^Conv_(\d+)$")
_CMP_RE = re.compile(r"^ConvMeanPool_(\d+)$")
_ADAPT_RE = re.compile(r"^adapt_(\d+)$")


def _rcu_conv_name(j: int, n_stages: int = 2) -> str:
    """Flax auto-name Conv_{j} (blocks outer, stages inner) -> the
    reference RCUBlock's ``{block}_{stage}_conv`` attribute
    (ncsn/models/layers.py:112-124 setattr grammar)."""
    return f"{j // n_stages + 1}_{j % n_stages + 1}_conv"


def flax_to_torch_candidates(path: Sequence[str]) -> List[str]:
    """Torch state-dict key candidates for one flax param path.

    Returns candidates in priority order: where the reference nests a conv
    inside ``Sequential(ZeroPad2d, conv)`` (adjust_padding=True,
    layers.py:304-307) the same logical weight lives at ``....conv.1.weight``
    instead of ``....conv.weight``; both are emitted and the first present
    in the state dict wins.
    """
    parts = list(path)
    leaf = parts[-1]
    leaf_t = {"kernel": "weight", "bias": "bias"}.get(leaf, leaf)

    def finish(prefix_parts: List[str]) -> List[str]:
        return [".".join(prefix_parts + [leaf_t])]

    head = parts[0]

    # top level: begin_conv / end_conv / normalizer, plus NCSN3DShallow's
    # asymmetric temporal convs (ncsn/models/ncsn3d.py:176-177)
    if head in ("begin_conv", "end_conv", "normalizer",
                "conv_temporal_down", "conv_temporal_up"):
        return finish([head])

    m = _RES_RE.match(head)
    if m:
        stage, idx = m.groups()
        base = [f"res{stage}", idx]
        inner = parts[1]
        if inner == "norm1":
            return finish(base + ["normalize1"])
        if inner == "norm2":
            return finish(base + ["normalize2"])
        mc = _CONV_RE.match(inner)
        if mc:
            # Conv_0 = conv1; Conv_1 = conv2 (dilated / plain);
            # Conv_2 = shortcut (dilated conv3x3 or conv1x1)
            name = {0: "conv1", 1: "conv2", 2: "shortcut"}[int(mc.group(1))]
            return finish(base + [name])
        mp = _CMP_RE.match(inner)
        if mp:
            # ConvMeanPool_0 = conv2, ConvMeanPool_1 = shortcut (the
            # non-dilated 'down' branch, layers.py:417-421); the inner
            # flax Conv_0 maps onto .conv(.1 with adjust_padding)
            name = {0: "conv2", 1: "shortcut"}[int(mp.group(1))]
            stem = base + [name, "conv"]
            return ([".".join(stem + [leaf_t])] +
                    [".".join(stem + ["1", leaf_t])])
        raise KeyError(f"unrecognized residual sub-path: {path}")

    if head.startswith("refine"):
        base = [head]
        inner = parts[1]
        ma = _ADAPT_RE.match(inner)
        if ma:
            j = int(_CONV_RE.match(parts[2]).group(1))
            return finish(base + ["adapt_convs", ma.group(1),
                                  _rcu_conv_name(j)])
        if inner == "output":
            j = int(_CONV_RE.match(parts[2]).group(1))
            return finish(base + ["output_convs", _rcu_conv_name(j)])
        if inner == "msf":
            i = _CONV_RE.match(parts[2]).group(1)
            return finish(base + ["msf", "convs", i])
        if inner == "crp":
            i = _CONV_RE.match(parts[2]).group(1)
            return finish(base + ["crp", "convs", i])
        raise KeyError(f"unrecognized refine sub-path: {path}")

    raise KeyError(f"unrecognized flax param path: {path}")


def torch_to_flax_array(arr: np.ndarray, flax_shape: Tuple[int, ...],
                        leaf: str, transposed_conv: bool = False
                        ) -> np.ndarray:
    """Transpose a torch tensor into the flax layout for this leaf.
    Conv kernels go (O, I, *k) -> (*k, I, O); ConvTranspose kernels are
    stored (I, O, *k) by torch and go -> (*k, I, O); vectors pass through."""
    arr = np.asarray(arr)
    if leaf == "kernel":
        nspatial = arr.ndim - 2
        if transposed_conv:
            perm = tuple(range(2, 2 + nspatial)) + (0, 1)
        else:
            perm = tuple(range(2, 2 + nspatial)) + (1, 0)
        arr = arr.transpose(perm)
    if tuple(arr.shape) != tuple(flax_shape):
        raise ValueError(f"shape mismatch after layout transpose: "
                         f"torch->{arr.shape} vs flax {flax_shape}")
    return arr


def convert_ncsn_state_dict(torch_sd: Dict[str, np.ndarray],
                            model: nn.Module,
                            strict_unused: bool = True
                            ) -> Dict[str, torch.Tensor]:
    """The state dict of `model`, an NCSNv2-family net, from a reference
    torch state dict. Every template entry must be found (raises
    otherwise); with ``strict_unused`` any torch weight left unconsumed
    (other than the ``sigmas`` buffer, which lives in the sampler here)
    also raises. A BatchNorm net's running statistics have no reference
    key in this grammar, so they raise as missing."""
    flat = flax_layout(model)
    used = set()
    out = {}
    missing = []
    for path, leaf_val in flat.items():
        cands = flax_to_torch_candidates(path)
        key = next((c for c in cands if c in torch_sd), None)
        if key is None:
            missing.append((path, cands))
            continue
        out[path] = np.asarray(torch_to_flax_array(
            torch_sd[key], np.shape(leaf_val), path[-1],
            transposed_conv=(path[0] == "conv_temporal_up")), np.float32)
        used.add(key)
    if missing:
        lines = "\n".join(f"  {'/'.join(p)} <- tried {c}"
                          for p, c in missing[:10])
        raise KeyError(f"{len(missing)} params missing from torch state "
                       f"dict, e.g.:\n{lines}")
    if strict_unused:
        leftover = [k for k in torch_sd
                    if k not in used and not k.endswith("sigmas")]
        if leftover:
            raise KeyError(f"{len(leftover)} torch weights unconsumed, "
                           f"e.g. {leftover[:8]} — wrong architecture?")
    return _to_port(out, model, type(model).__name__)


def export_ncsn_state_dict(model: nn.Module,
                           adjust_padding: bool = False
                           ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_ncsn_state_dict`: emit a torch-layout
    state dict of the reference's key names from the port's NCSNv2-family
    net (round-trip testing, and exporting weights back to reference
    tooling). ``adjust_padding`` selects the ``Sequential`` nesting for
    ConvMeanPool convs (28x28 nets)."""
    flat = flax_layout(model)
    sd = {}
    for path, leaf_val in flat.items():
        cands = flax_to_torch_candidates(path)
        key = cands[1] if (adjust_padding and len(cands) > 1) else cands[0]
        arr = np.asarray(leaf_val)
        if path[-1] == "kernel":
            nspatial = arr.ndim - 2
            if path[0] == "conv_temporal_up":   # torch stores (I, O, *k)
                perm = (nspatial, nspatial + 1) + tuple(range(nspatial))
            else:
                perm = (nspatial + 1, nspatial) + tuple(range(nspatial))
            arr = arr.transpose(perm)
        sd[key] = np.ascontiguousarray(arr)
    return sd


# ---------------------------------------------------------------------------
# small pytree helpers
# ---------------------------------------------------------------------------

def _unflatten(flat: Mapping[Path, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


# ---------------------------------------------------------------------------
# Continuous-stack NCSN++ (models/ncsnpp.py)
# ---------------------------------------------------------------------------

def ncsnpp_index_map(config) -> Dict[str, int]:
    """Map the Flax NCSN++ top-level module names (which the port keeps,
    models/ncsnpp.py) to the reference's flat ``all_modules`` list indices
    (models/ncsnpp.py:68-230).

    The reference appends every parameterised submodule to one ModuleList
    in construction order; this walk replays that order from the same
    config, so ``all_modules.{i}.<sub>.<leaf>`` keys can be resolved to the
    named modules. The two no-conv pyramid resamplers are attributes, not
    list entries (ncsnpp.py:101,110), so they consume no index.
    """
    m = config.model
    ch_mult = tuple(m.ch_mult)
    L = len(ch_mult)
    num_res_blocks = m.num_res_blocks
    attn_res = tuple(m.attn_resolutions)
    all_res = [config.data.image_size // (2**i) for i in range(L)]
    ddpm_blocks = m.resblock_type.lower() == "ddpm"
    progressive = m.progressive.lower()
    progressive_input = m.progressive_input.lower()

    out: Dict[str, int] = {}
    idx = 0

    def put(name):
        nonlocal idx
        out[name] = idx
        idx += 1

    if m.embedding_type.lower() == "fourier":
        put("fourier_proj")
    if m.conditional:
        put("temb_dense0")
        put("temb_dense1")
    put("conv_in")

    block = 0
    for i_level in range(L):
        for i_block in range(num_res_blocks):
            put(f"res_{block}")
            block += 1
            if all_res[i_level] in attn_res:
                put(f"attn_d{i_level}_{i_block}")
        if i_level != L - 1:
            if ddpm_blocks:
                put(f"down_{i_level}")
            else:
                put(f"res_{block}")
                block += 1
            if progressive_input == "input_skip":
                put(f"combine_{i_level}")
            elif progressive_input == "residual":
                put(f"pyr_down_{i_level}")

    put(f"res_{block}"); block += 1
    put("attn_mid")
    put(f"res_{block}"); block += 1

    for i_level in reversed(range(L)):
        for _ in range(num_res_blocks + 1):
            put(f"res_{block}")
            block += 1
        if all_res[i_level] in attn_res:
            put(f"attn_u{i_level}")
        if progressive != "none":
            if i_level == L - 1 or progressive == "output_skip":
                put(f"pyr_norm_{i_level}")
                put(f"pyr_conv_{i_level}")
            else:  # residual, below the top level
                put(f"pyr_up_{i_level}")
        if i_level != 0:
            if ddpm_blocks:
                put(f"up_{i_level}")
            else:
                put(f"res_{block}")
                block += 1

    if progressive != "output_skip":
        put("norm_out")
        put("conv_out")
    return out


def ddpm_index_map(config) -> Dict[str, int]:
    """all_modules index map for the original DDPM UNet
    (models/ddpm.py:58-106): the same walk as NCSN++ minus embeddings,
    pyramids, and resampling res-blocks."""
    m = config.model
    ch_mult = tuple(m.ch_mult)
    L = len(ch_mult)
    num_res_blocks = m.num_res_blocks
    attn_res = tuple(m.attn_resolutions)
    all_res = [config.data.image_size // (2**i) for i in range(L)]

    out: Dict[str, int] = {}
    idx = 0

    def put(name):
        nonlocal idx
        out[name] = idx
        idx += 1

    if m.conditional:
        put("temb_dense0")
        put("temb_dense1")
    put("conv_in")
    block = 0
    for i_level in range(L):
        for i_block in range(num_res_blocks):
            put(f"res_{block}")
            block += 1
            if all_res[i_level] in attn_res:
                put(f"attn_d{i_level}_{i_block}")
        if i_level != L - 1:
            put(f"down_{i_level}")
    put(f"res_{block}"); block += 1
    put("attn_mid")
    put(f"res_{block}"); block += 1
    for i_level in reversed(range(L)):
        for _ in range(num_res_blocks + 1):
            put(f"res_{block}")
            block += 1
        if all_res[i_level] in attn_res:
            put(f"attn_u{i_level}")
        if i_level != 0:
            put(f"up_{i_level}")
    put("norm_out")
    put("conv_out")
    return out


def convert_ncsnpp_state_dict(torch_sd: Dict[str, np.ndarray],
                              model: nn.Module, config
                              ) -> Dict[str, torch.Tensor]:
    """The state dict of `model`, the port's NCSN++, from a reference state
    dict.

    Leaf grammar (reference models/layerspp.py keeps the same submodule
    names the port uses - GroupNorm_0/1, Conv_0/1/2, NIN_0..3, Dense_0,
    Conv2d_0):
      kernel (4-D)       <- weight, (O, I, kh, kw) -> (kh, kw, I, O)
      kernel (2-D Dense) <- weight, (out, in) -> (in, out)
      scale              <- weight (GroupNorm)
      Conv2d_0_weight    <- Conv2d_0.weight (fused-FIR conv, OIHW -> HWIO)
      W / b / bias       <- unchanged (NIN and GaussianFourierProjection
                            store (in, out) / (n,) on both sides)
    """
    return _convert_indexed_state_dict(torch_sd, model,
                                       ncsnpp_index_map(config))


def convert_ddpm_state_dict(torch_sd: Dict[str, np.ndarray],
                            model: nn.Module, config
                            ) -> Dict[str, torch.Tensor]:
    """The state dict of `model`, the port's DDPM UNet, from a reference
    state dict (models/ddpm.py; the same leaf grammar as NCSN++,
    models/layers.py keeps the GroupNorm_0/Conv_0/NIN_0/Dense_0 names)."""
    return _convert_indexed_state_dict(torch_sd, model,
                                       ddpm_index_map(config))


def _convert_indexed_state_dict(torch_sd: Dict[str, np.ndarray],
                                model: nn.Module,
                                index_map: Dict[str, int]
                                ) -> Dict[str, torch.Tensor]:
    flat = flax_layout(model)
    out: Dict[Path, np.ndarray] = {}
    missing: List[Tuple[Path, str]] = []
    for path, leaf_val in flat.items():
        top, subs, leaf = path[0], path[1:-1], path[-1]
        if top not in index_map:
            raise KeyError(f"no all_modules index for flax module {top!r}")
        prefix = [f"all_modules.{index_map[top]}", *subs]
        if leaf in ("Conv2d_0_weight", "Conv2d_0_bias"):
            key = ".".join(prefix + [leaf.replace("_weight", ".weight")
                                     .replace("_bias", ".bias")])
        else:
            leaf_t = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
            key = ".".join(prefix + [leaf_t])
        if key not in torch_sd:
            missing.append((path, key))
            continue
        arr = np.asarray(torch_sd[key])
        if leaf == "kernel" or leaf == "Conv2d_0_weight":
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.transpose(1, 0)
        want_shape = tuple(np.shape(leaf_val))
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                             f"torch {key} {arr.shape} vs flax {want_shape}")
        out[path] = arr.astype(np.asarray(leaf_val).dtype)
    if missing:
        lines = "\n".join(f"  {'/'.join(p)} <- tried {k}"
                          for p, k in missing[:10])
        raise KeyError(f"{len(missing)} params missing from torch state "
                       f"dict, e.g.:\n{lines}")
    return _to_port(out, model, type(model).__name__)


def convert_continuous_state_dict(torch_sd: Dict[str, np.ndarray],
                                  model: nn.Module, config
                                  ) -> Dict[str, torch.Tensor]:
    """Continuous-zoo converter dispatch on `config.model.name`
    (the reference registry names, models/utils.py:27-46): ncsnpp/ddpm use
    the all_modules-order converters; the ncsnv2_* sizes share the
    NCSNv2-family layout (models/ncsnv2.py keeps the discrete stack's
    attribute names res{s}/refine{r}/begin_conv/...); `ncsn` uses the
    conditional grammar, though the reference's continuous NCSN v1 cannot
    be constructed at all (ConditionalResidualBlock(dilation=None) hits
    `None > 1`, models/layers.py:464), so no reference checkpoint of it
    exists to import."""
    name = config.model.name
    if name == "ncsnpp":
        return convert_ncsnpp_state_dict(torch_sd, model, config)
    if name == "ddpm":
        return convert_ddpm_state_dict(torch_sd, model, config)
    if name.startswith("ncsnv2"):
        return convert_ncsn_state_dict(torch_sd, model)
    if name in ("ncsn", "ncsn_deeper"):
        return convert_cond_ncsn_state_dict(torch_sd, model)
    raise KeyError(f"no torch importer for continuous model {name!r}")


# ---------------------------------------------------------------------------
# NCSN v1 (conditional RefineNet; ncsn/models/ncsn.py, models/ncsnv2.py NCSN)
# ---------------------------------------------------------------------------

_COND_RCU_NORM_RE = re.compile(r"^norm_(\d+)_(\d+)$")
_COND_ONE_NORM_RE = re.compile(r"^norm_(\d+)$")
_EMBED_LEAVES = {"gamma_embed": 0, "alpha_embed": 1, "beta_embed": 2}


def _cond_norm_slice(weight: np.ndarray, leaf: str, nf: int) -> np.ndarray:
    """Split a conditional-norm Embedding weight (num_classes, k*nf) into
    the reference's chunk order - gamma, alpha[, beta]
    (ncsn/models/normalization.py:200-207 chunk(3); bias=False chunks 2)."""
    return weight[:, _EMBED_LEAVES[leaf] * nf:(_EMBED_LEAVES[leaf] + 1) * nf]


def cond_ncsn_torch_prefix(parts: Sequence[str]) -> str:
    """Torch module prefix for a flax NCSN-v1 module path (leaf excluded).

    Grammar (reference ncsn/models/ncsn.py:9-100, layers.py:86-290
    conditional blocks): `res{s}_{i}` -> `res{s}.{i}` with norm1/norm2 ->
    normalize1/normalize2 and the v2 conv enumeration; `refine{r}` subs
    adapt_{i} -> adapt_convs.{i}, output -> output_convs, crp/msf keep
    their names with `norm_{i}` -> `norms.{i}` and autonamed convs ->
    `convs.{i}` / `{b}_{s}_conv`.
    """
    head = parts[0]
    if head in ("begin_conv", "end_conv", "normalizer"):
        return ".".join([head, *parts[1:]])

    m = _RES_RE.match(head)
    if m:
        stage, idx = m.groups()
        base = [f"res{stage}", idx]
        in_cmp = False
        for p in parts[1:]:
            if p == "norm1":
                base.append("normalize1")
            elif p == "norm2":
                base.append("normalize2")
            else:
                mc = _CONV_RE.match(p)
                mp = _CMP_RE.match(p)
                if mc and in_cmp:
                    # the flax Conv inside ConvMeanPool IS torch's `.conv`
                    in_cmp = False
                elif mc:
                    base.append({0: "conv1", 1: "conv2",
                                 2: "shortcut"}[int(mc.group(1))])
                elif mp:
                    base.append({0: "conv2",
                                 1: "shortcut"}[int(mp.group(1))])
                    base.append("conv")
                    in_cmp = True
                else:
                    raise KeyError(f"unrecognized res sub-path: {parts}")
        return ".".join(base)

    if head.startswith("refine"):
        base = [head]
        rest = list(parts[1:])
        inner = rest.pop(0)
        ma = _ADAPT_RE.match(inner)
        if ma:
            base += ["adapt_convs", ma.group(1)]
            rcu = True
        elif inner == "output":
            base.append("output_convs")
            rcu = True
        elif inner in ("crp", "msf"):
            base.append(inner)
            rcu = False
        else:
            raise KeyError(f"unrecognized refine sub-path: {parts}")
        for p in rest:
            mn = _COND_RCU_NORM_RE.match(p)
            m1 = _COND_ONE_NORM_RE.match(p)
            mc = _CONV_RE.match(p)
            if rcu and mn:
                base.append(f"{int(mn.group(1)) + 1}_"
                            f"{int(mn.group(2)) + 1}_norm")
            elif not rcu and m1:
                base += ["norms", m1.group(1)]
            elif rcu and mc:
                base.append(_rcu_conv_name(int(mc.group(1))))
            elif not rcu and mc:
                base += ["convs", mc.group(1)]
            else:
                raise KeyError(f"unrecognized refine sub-path: {parts}")
        return ".".join(base)

    raise KeyError(f"unrecognized flax param path: {parts}")


def convert_cond_ncsn_state_dict(torch_sd: Dict[str, np.ndarray],
                                 model: nn.Module
                                 ) -> Dict[str, torch.Tensor]:
    """The state dict of `model`, an NCSN-v1 (conditional RefineNet), from
    a reference state dict. Conditional-norm embeddings are stored as one
    torch Embedding weight (num_classes, {2,3}*nf) and split into the
    gamma/alpha/beta_embed entries; everything else follows the NCSNv2
    layout rules (torch_to_flax_array)."""
    flat = flax_layout(model)
    out: Dict[Path, np.ndarray] = {}
    missing: List[Tuple[Path, str]] = []
    for path, leaf_val in flat.items():
        leaf = path[-1]
        prefix = cond_ncsn_torch_prefix(path[:-1])
        if leaf in _EMBED_LEAVES:
            key = f"{prefix}.embed.weight"
            if key not in torch_sd:
                missing.append((path, key))
                continue
            nf = int(np.shape(leaf_val)[1])
            arr = _cond_norm_slice(np.asarray(torch_sd[key]), leaf, nf)
        else:
            leaf_t = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
            key = f"{prefix}.{leaf_t}"
            if key not in torch_sd:
                # adjust_padding wraps the conv in Sequential(pad, conv)
                key2 = f"{prefix}.1.{leaf_t}"
                if key2 not in torch_sd:
                    missing.append((path, key))
                    continue
                key = key2
            arr = torch_to_flax_array(np.asarray(torch_sd[key]),
                                      np.shape(leaf_val), leaf)
        want_shape = tuple(np.shape(leaf_val))
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                             f"torch {key} {arr.shape} vs flax {want_shape}")
        out[path] = arr.astype(np.asarray(leaf_val).dtype)
    if missing:
        lines = "\n".join(f"  {'/'.join(p)} <- tried {k}"
                          for p, k in missing[:10])
        raise KeyError(f"{len(missing)} params missing from torch state "
                       f"dict, e.g.:\n{lines}")
    return _to_port(out, model, type(model).__name__)
