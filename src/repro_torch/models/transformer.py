"""Config-driven decoder LM, for the layer kinds this slice carries.

The port of the reference's ``models/transformer.py``.  Layers are
grouped into config-declared *segments*: a repeating unit of layer
specs, run ``repeats`` times.  The reference stacks each repeat's
parameters on a leading axis and ``lax.scan``s over them; here each
repeat keeps its own parameters and a Python loop walks them, so the
trees read

    params["segment_<i>"][repeat][unit_index] -> layer params
    cache["segment_<i>"][repeat][unit_index]  -> layer cache

(``interop.lm_params_to_torch`` and ``interop.lm_cache_to_numpy`` map
them to and from the reference's stacked trees).

This slice carries the ``mixer="attn"`` / ``mlp="dense"`` layer, with
the ``parallel_block`` variant; ``mla``, ``mamba``, ``rwkv``, ``moe`` and
``rwkv_cmix`` layers raise (ROADMAP: "The rest of the model stack").
"""

from __future__ import annotations

from typing import Any

import torch

from . import attention, layers
from .._device import get_device
from ..configs.base import LayerSpec, ModelConfig


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer != "attn" or spec.mlp != "dense":
        raise NotImplementedError(
            f"mixer={spec.mixer!r}, mlp={spec.mlp!r} is not ported yet "
            f"(ROADMAP: \"The rest of the model stack\")")


# ---------------------------------------------------------------------------
# Sub-layer init/apply
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, spec: LayerSpec, cfg,
                device: torch.device) -> dict:
    _check_spec(spec)
    ninit, _ = layers.make_norm(cfg.norm)
    dt = cfg.torch_dtype
    return {
        "norm1": ninit(cfg.d_model, dt, device),
        "mixer": attention.gqa_init(gen, cfg, device),
        "norm2": ninit(cfg.d_model, dt, device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt,
                               device),
    }


def _residual(params: dict, x: torch.Tensor, h1: torch.Tensor,
              mix: torch.Tensor, cfg, napply) -> torch.Tensor:
    """The layer's MLP half: ``x + mix + mlp(h1)`` in a parallel block
    (attention and MLP read the same normed input), else
    ``x' + mlp(norm2(x'))`` with ``x' = x + mix``."""
    if cfg.parallel_block:
        return x + mix + layers.mlp_apply(params["mlp"], h1, cfg.act)
    x = x + mix
    h2 = napply(params["norm2"], x)
    return x + layers.mlp_apply(params["mlp"], h2, cfg.act)


def _layer_apply(params: dict, x: torch.Tensor, spec: LayerSpec,
                 cfg) -> torch.Tensor:
    _check_spec(spec)
    _, napply = layers.make_norm(cfg.norm)
    h1 = napply(params["norm1"], x)
    mix = attention.gqa_apply(params["mixer"], h1, cfg)
    return _residual(params, x, h1, mix, cfg, napply)


def _layer_prefill(params: dict, x: torch.Tensor, spec: LayerSpec, cfg,
                   max_len: int) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt, emitting this layer's decode cache."""
    _check_spec(spec)
    _, napply = layers.make_norm(cfg.norm)
    h1 = napply(params["norm1"], x)
    mix, mcache = attention.gqa_prefill(params["mixer"], h1, cfg, max_len)
    return _residual(params, x, h1, mix, cfg, napply), {"mixer": mcache}


def _layer_decode(params: dict, x: torch.Tensor, cache: dict, length: int,
                  spec: LayerSpec, cfg) -> tuple[torch.Tensor, dict]:
    _check_spec(spec)
    _, napply = layers.make_norm(cfg.norm)
    h1 = napply(params["norm1"], x)
    mix, mcache = attention.gqa_decode(params["mixer"], h1, cache["mixer"],
                                       length, cfg)
    new_cache = dict(cache)
    new_cache["mixer"] = mcache
    return _residual(params, x, h1, mix, cfg, napply), new_cache


def _layer_init_cache(spec: LayerSpec, cfg, batch: int, max_len: int,
                      device: torch.device) -> dict:
    _check_spec(spec)
    return {"mixer": attention.gqa_init_cache(cfg, batch, max_len, device)}


# ---------------------------------------------------------------------------
# Whole-model init / forward / decode
# ---------------------------------------------------------------------------

def _final_logits(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    _, napply = layers.make_norm(cfg.norm)
    x = napply(params["final_norm"], x)
    emb = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return layers.unembed_apply(emb, x)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: str | torch.device | None = None) -> dict:
    """Random parameters drawn from ``gen``, placed on ``device`` (default:
    the port's device policy) in ``cfg``'s dtype."""
    dev = get_device(device)
    dt = cfg.torch_dtype
    params: dict[str, Any] = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                       dev),
    }
    ninit, _ = layers.make_norm(cfg.norm)
    params["final_norm"] = ninit(cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = layers.embedding_init(
            gen, cfg.vocab_size, cfg.d_model, dt, dev)
    for si, seg in enumerate(cfg.segments):
        params[f"segment_{si}"] = [
            [_layer_init(gen, spec, cfg, dev) for spec in seg.unit]
            for _ in range(seg.repeats)]
    return params


def forward(params: dict, tokens: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Full-sequence causal forward.  Returns (logits, aux)."""
    x = layers.embedding_apply(params["embed"], tokens)
    for si, seg in enumerate(cfg.segments):
        for rep_params in params[f"segment_{si}"]:
            for j, spec in enumerate(seg.unit):
                x = _layer_apply(rep_params[j], x, spec, cfg)
    return _final_logits(params, x, cfg), {
        "lb_loss": torch.zeros((), device=x.device)}


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Prompt forward + cache build.  Returns (last-position logits, cache)."""
    x = layers.embedding_apply(params["embed"], tokens)
    cache: dict[str, Any] = {}
    for si, seg in enumerate(cfg.segments):
        seg_cache = []
        for rep_params in params[f"segment_{si}"]:
            rep_cache = []
            for j, spec in enumerate(seg.unit):
                x, c = _layer_prefill(rep_params[j], x, spec, cfg, max_len)
                rep_cache.append(c)
            seg_cache.append(rep_cache)
        cache[f"segment_{si}"] = seg_cache
    return _final_logits(params, x[:, -1:, :], cfg)[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device | None = None) -> dict:
    dev = get_device(device)
    return {f"segment_{si}": [
        [_layer_init_cache(spec, cfg, batch, max_len, dev)
         for spec in seg.unit] for _ in range(seg.repeats)]
        for si, seg in enumerate(cfg.segments)}


def decode_step(params: dict, token: torch.Tensor, cache: dict, length: int,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One new token for every sequence.  token: (B,) int; length: tokens
    already in the cache.  Returns (logits (B, vocab), cache), the cache
    updated in place."""
    x = layers.embedding_apply(params["embed"], token[:, None])
    new_cache: dict[str, Any] = {}
    for si, seg in enumerate(cfg.segments):
        seg_cache = []
        for rep_params, rep_cache in zip(params[f"segment_{si}"],
                                         cache[f"segment_{si}"]):
            new_rep_cache = []
            for j, spec in enumerate(seg.unit):
                x, c = _layer_decode(rep_params[j], x, rep_cache[j], length,
                                     spec, cfg)
                new_rep_cache.append(c)
            seg_cache.append(new_rep_cache)
        new_cache[f"segment_{si}"] = seg_cache
    return _final_logits(params, x, cfg)[:, 0], new_cache
