"""Config-driven decoder LM: dense / MoE / hybrid / SSM, one code path.

The port of the reference's ``models/transformer.py``.  Layers are
grouped into config-declared *segments*: a repeating unit of layer
specs, run ``repeats`` times.  The reference stacks each repeat's
parameters on a leading axis and ``lax.scan``s over them; here each
repeat keeps its own parameters and a Python loop walks them, so the
trees read

    params["segment_<i>"][repeat][unit_index] -> layer params
    cache["segment_<i>"][repeat][unit_index]  -> layer cache

(``interop.lm_params_to_torch`` and ``interop.lm_cache_to_numpy`` map
them to and from the reference's stacked trees).  A layer's mixer is
``attn`` (GQA), ``mla``, ``mamba`` or ``rwkv``; its MLP ``dense``,
``moe`` or ``rwkv_cmix``; ``cfg.parallel_block`` runs mixer and MLP on
the same normed input (Cohere).  With ``cfg.frontend_stub`` (audio and
vision front ends), a 3-D input to :func:`forward` or :func:`prefill` is
embeddings, not tokens.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import attention, layers, moe, ssm
from .._device import get_device
from ..configs.base import LayerSpec, ModelConfig


# ---------------------------------------------------------------------------
# RWKV channel mix (the FFN used with rwkv mixer layers)
# ---------------------------------------------------------------------------

def _cmix_init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    d, dt = cfg.d_model, cfg.torch_dtype
    dh = int(3.5 * d)
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dt, device=device),
        "w_k": layers._dense_init(gen, d, dh, dt, device),
        "w_v": layers._dense_init(gen, dh, d, dt, device),
        "w_r": layers._dense_init(gen, d, d, dt, device),
    }


def _cmix_apply(params, x, prev=None):
    xs = ssm._token_shift(x, prev)
    xk = ssm._rwkv_mix(x, xs, params["mu_k"])
    k = torch.square(F.relu((xk @ params["w_k"]).float()))
    r = torch.sigmoid((x @ params["w_r"]).float())
    return (r * (k.to(x.dtype) @ params["w_v"]).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Sub-layer init/apply dispatch
# ---------------------------------------------------------------------------

def _mixer_init(gen, spec: LayerSpec, cfg, device) -> dict:
    if spec.mixer == "attn":
        return attention.gqa_init(gen, cfg, device)
    if spec.mixer == "mla":
        return attention.mla_init(gen, cfg, device)
    if spec.mixer == "mamba":
        return ssm.mamba_init(gen, cfg, device)
    if spec.mixer == "rwkv":
        return ssm.rwkv6_init(gen, cfg, device)
    raise ValueError(spec.mixer)


def _mlp_init(gen, spec: LayerSpec, cfg, device) -> dict:
    if spec.mlp == "dense":
        return layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act,
                               cfg.torch_dtype, device)
    if spec.mlp == "moe":
        return moe.moe_init(gen, cfg, device)
    if spec.mlp == "rwkv_cmix":
        return _cmix_init(gen, cfg, device)
    raise ValueError(spec.mlp)


def _layer_init(gen: torch.Generator, spec: LayerSpec, cfg,
                device: torch.device) -> dict:
    ninit, _ = layers.make_norm(cfg.norm)
    dt = cfg.torch_dtype
    return {
        "norm1": ninit(cfg.d_model, dt, device),
        "mixer": _mixer_init(gen, spec, cfg, device),
        "norm2": ninit(cfg.d_model, dt, device),
        "mlp": _mlp_init(gen, spec, cfg, device),
    }


def _mlp_apply(params: dict, h: torch.Tensor, spec: LayerSpec, cfg,
               cache: dict | None, new_cache: dict | None,
               aux_acc: dict | None) -> torch.Tensor:
    """The layer's MLP on ``h``.  A MoE's load-balance loss is summed into
    ``aux_acc`` when given; a channel mix reads its carried input from
    ``cache`` (decode) and leaves its last input in ``new_cache``."""
    if spec.mlp == "moe":
        ff, aux = moe.moe_apply(params["mlp"], h, cfg)
        if aux_acc is not None:
            aux_acc["lb_loss"] = aux_acc.get("lb_loss", 0.0) + aux["lb_loss"]
        return ff
    if spec.mlp == "rwkv_cmix":
        prev = cache.get("cmix_prev") if cache is not None else None
        ff = _cmix_apply(params["mlp"], h, prev=prev)
        if new_cache is not None:
            new_cache["cmix_prev"] = h[:, -1:, :]
        return ff
    return layers.mlp_apply(params["mlp"], h, cfg.act)


def _residual(params: dict, x: torch.Tensor, h1: torch.Tensor,
              mix: torch.Tensor, spec: LayerSpec, cfg, napply,
              cache: dict | None = None, new_cache: dict | None = None,
              aux_acc: dict | None = None) -> torch.Tensor:
    """The layer's MLP half: ``x + mix + mlp(h1)`` in a parallel block
    (mixer and MLP read the same normed input), else
    ``x' + mlp(norm2(x'))`` with ``x' = x + mix``."""
    if cfg.parallel_block:
        return x + mix + _mlp_apply(params, h1, spec, cfg, cache,
                                    new_cache, aux_acc)
    x = x + mix
    h2 = napply(params["norm2"], x)
    return x + _mlp_apply(params, h2, spec, cfg, cache, new_cache, aux_acc)


def _layer_apply(params: dict, x: torch.Tensor, spec: LayerSpec, cfg,
                 aux_acc: dict) -> torch.Tensor:
    _, napply = layers.make_norm(cfg.norm)
    h1 = napply(params["norm1"], x)
    if spec.mixer == "attn":
        mix = attention.gqa_apply(params["mixer"], h1, cfg)
    elif spec.mixer == "mla":
        mix = attention.mla_apply(params["mixer"], h1, cfg)
    elif spec.mixer == "mamba":
        mix = ssm.mamba_apply(params["mixer"], h1, cfg)
    elif spec.mixer == "rwkv":
        mix = ssm.rwkv6_apply(params["mixer"], h1, cfg)
    else:
        raise ValueError(spec.mixer)
    return _residual(params, x, h1, mix, spec, cfg, napply, aux_acc=aux_acc)


def _layer_prefill(params: dict, x: torch.Tensor, spec: LayerSpec, cfg,
                   max_len: int) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt, emitting this layer's decode cache."""
    _, napply = layers.make_norm(cfg.norm)
    h1 = napply(params["norm1"], x)
    if spec.mixer == "attn":
        mix, mcache = attention.gqa_prefill(params["mixer"], h1, cfg,
                                            max_len)
    elif spec.mixer == "mla":
        mix, mcache = attention.mla_prefill(params["mixer"], h1, cfg,
                                            max_len)
    elif spec.mixer == "mamba":
        mix, mcache = ssm.mamba_apply(params["mixer"], h1, cfg,
                                      return_cache=True)
    elif spec.mixer == "rwkv":
        mix, mcache = ssm.rwkv6_apply(params["mixer"], h1, cfg,
                                      return_cache=True)
    else:
        raise ValueError(spec.mixer)
    new_cache: dict[str, Any] = {"mixer": mcache}
    return _residual(params, x, h1, mix, spec, cfg, napply,
                     new_cache=new_cache), new_cache


def _layer_decode(params: dict, x: torch.Tensor, cache: dict, length: int,
                  spec: LayerSpec, cfg) -> tuple[torch.Tensor, dict]:
    _, napply = layers.make_norm(cfg.norm)
    h1 = napply(params["norm1"], x)
    if spec.mixer == "attn":
        mix, mcache = attention.gqa_decode(params["mixer"], h1,
                                           cache["mixer"], length, cfg)
    elif spec.mixer == "mla":
        mix, mcache = attention.mla_decode(params["mixer"], h1,
                                           cache["mixer"], length, cfg)
    elif spec.mixer == "mamba":
        mix, mcache = ssm.mamba_decode(params["mixer"], h1, cache["mixer"],
                                       cfg)
    elif spec.mixer == "rwkv":
        mix, mcache = ssm.rwkv6_decode(params["mixer"], h1, cache["mixer"],
                                       cfg)
    else:
        raise ValueError(spec.mixer)
    new_cache = dict(cache)
    new_cache["mixer"] = mcache
    return _residual(params, x, h1, mix, spec, cfg, napply, cache=cache,
                     new_cache=new_cache), new_cache


def _layer_init_cache(spec: LayerSpec, cfg, batch: int, max_len: int,
                      device: torch.device) -> dict:
    c: dict[str, Any] = {}
    if spec.mixer == "attn":
        c["mixer"] = attention.gqa_init_cache(cfg, batch, max_len, device)
    elif spec.mixer == "mla":
        c["mixer"] = attention.mla_init_cache(cfg, batch, max_len, device)
    elif spec.mixer == "mamba":
        c["mixer"] = ssm.mamba_init_cache(cfg, batch, device)
    elif spec.mixer == "rwkv":
        c["mixer"] = ssm.rwkv6_init_cache(cfg, batch, device)
    if spec.mlp == "rwkv_cmix":
        c["cmix_prev"] = torch.zeros((batch, 1, cfg.d_model),
                                     dtype=cfg.torch_dtype, device=device)
    return c


# ---------------------------------------------------------------------------
# Whole-model init / forward / decode
# ---------------------------------------------------------------------------

def _final_norm(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    _, napply = layers.make_norm(cfg.norm)
    return napply(params["final_norm"], x)


def _unembed(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    emb = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return layers.unembed_apply(emb, x)


def _final_logits(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    return _unembed(params, _final_norm(params, x, cfg), cfg)


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


def _inputs(params: dict, tokens_or_embeds: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Token ids through the embedding, or (``cfg.frontend_stub``, 3-D)
    embeddings as they are, in the model's dtype."""
    if cfg.frontend_stub and tokens_or_embeds.ndim == 3:
        return tokens_or_embeds.to(cfg.torch_dtype)
    return layers.embedding_apply(params["embed"], tokens_or_embeds)


def _repeat_apply(rep_params: list, x: torch.Tensor, unit, cfg
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One repeat of a segment's unit: the output and the repeat's summed
    load-balance loss (fp32; 0 without MoE layers)."""
    aux_acc: dict[str, Any] = {}
    for j, spec in enumerate(unit):
        x = _layer_apply(rep_params[j], x, spec, cfg, aux_acc)
    lb = torch.as_tensor(aux_acc.get("lb_loss", 0.0), dtype=torch.float32,
                         device=x.device)
    return x, lb


def forward(params: dict, tokens_or_embeds: torch.Tensor,
            cfg: ModelConfig, *,
            return_hidden: bool = False) -> tuple[torch.Tensor, dict]:
    """Full-sequence causal forward.  Returns (logits, aux), aux holding
    the MoE layers' summed load-balance loss and, with ``return_hidden``,
    the final-normed hidden states (DeepSeek-V3's MTP loss reads them).

    With ``cfg.remat`` each repeat of a segment's unit runs under
    activation checkpointing, as the reference wraps each repeat's body
    in ``jax.checkpoint``: backward keeps only the repeat's input and
    recomputes the layers inside."""
    x = _inputs(params, tokens_or_embeds, cfg)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, seg in enumerate(cfg.segments):
        for rep_params in params[f"segment_{si}"]:
            if cfg.remat:
                x, rep_lb = checkpoint(_repeat_apply, rep_params, x,
                                       seg.unit, cfg, use_reentrant=False)
            else:
                x, rep_lb = _repeat_apply(rep_params, x, seg.unit, cfg)
            lb = lb + rep_lb
    x = _final_norm(params, x, cfg)
    aux = {"lb_loss": lb}
    if return_hidden:
        aux["hidden"] = x
    return _unembed(params, x, cfg), aux


def prefill(params: dict, tokens_or_embeds: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Prompt forward + cache build.  Returns (last-position logits, cache)."""
    x = _inputs(params, tokens_or_embeds, cfg)
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


def _segment_decode(x: torch.Tensor, seg_params: list, seg_cache: list, *,
                    length: int, unit, cfg: ModelConfig
                    ) -> tuple[torch.Tensor, list]:
    """One segment's repeats in order, each a decode step of its unit's
    layers: the body of the reference's scan over the stacked repeats."""
    new_seg_cache = []
    for rep_params, rep_cache in zip(seg_params, seg_cache):
        new_rep_cache = []
        for j, spec in enumerate(unit):
            x, c = _layer_decode(rep_params[j], x, rep_cache[j], length,
                                 spec, cfg)
            new_rep_cache.append(c)
        new_seg_cache.append(new_rep_cache)
    return x, new_seg_cache


def decode_step(params: dict, token: torch.Tensor, cache: dict, length: int,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One new token for every sequence.  token: (B,) int; length: tokens
    already in the cache.  Returns (logits (B, vocab), cache), the cache
    updated in place."""
    x = layers.embedding_apply(params["embed"], token[:, None])
    new_cache: dict[str, Any] = {}
    for si, seg in enumerate(cfg.segments):
        x, new_cache[f"segment_{si}"] = _segment_decode(
            x, params[f"segment_{si}"], cache[f"segment_{si}"],
            length=length, unit=seg.unit, cfg=cfg)
    return _final_logits(params, x, cfg)[:, 0], new_cache
