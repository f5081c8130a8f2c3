"""Model facade: init / loss / prefill / decode / input_specs per arch.

The port of the reference's ``models/model.py`` — the public modelling
API the launchers, ``chip_smoke.py`` and the tests use.
:func:`init_params` builds DeepSeek-V3's multi-token-prediction head as
the reference does; :func:`loss_fn` is the next-token loss with MoE's
load balance and the MTP loss; :func:`input_specs` gives a cell's step
inputs as ``meta`` tensors (shape and dtype, no storage: the reference's
``ShapeDtypeStruct`` stand-ins).
"""

from __future__ import annotations

import torch

from . import layers, transformer
from .._device import get_device
from ..configs.base import InputShape, ModelConfig, SHAPES

LB_LOSS_WEIGHT = 0.01
MTP_LOSS_WEIGHT = 0.3


def init_params(gen: torch.Generator | None, cfg: ModelConfig,
                device: str | torch.device | None = None) -> dict:
    """Random parameters from ``gen`` on ``device`` (default: the card),
    with the MTP head (projection, one layer of the last unit's kind,
    norm) when ``cfg.mtp_depth > 0``.  ``gen=None`` with ``device="meta"``
    builds the shapes and dtypes only."""
    dev = get_device(device)
    params = transformer.init_params(gen, cfg, dev)
    if cfg.mtp_depth > 0:
        d = cfg.d_model
        params["mtp"] = {
            "proj": layers._dense_init(gen, 2 * d, d, cfg.torch_dtype, dev),
            "layer": transformer._layer_init(
                gen, cfg.segments[-1].unit[-1], cfg, dev),
            "norm": layers.rmsnorm_init(d, cfg.torch_dtype, dev),
        }
    return params


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in fp32.  logits (..., V), labels (...).

    The reference's ``take_along_axis`` semantics: a negative label wraps
    once, and a label still out of range reads NaN, so the mean is NaN
    (no label is dropped)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    V = logp.shape[-1]
    labels = labels.long()
    labels = torch.where(labels < 0, labels + V, labels)
    valid = (labels >= 0) & (labels < V)
    nll = -logp.gather(-1, labels.clamp(0, V - 1)[..., None])[..., 0]
    return torch.where(valid, nll, torch.nan).mean()


def loss_fn(params: dict, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
    """Next-token LM loss (+ MoE load-balance + optional MTP).  Returns
    (loss, metrics), every metric a 0-d fp32 tensor."""
    if cfg.frontend_stub and "embeds" in batch:
        inputs = batch["embeds"]
        labels = batch["labels"]
    else:
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits, aux = transformer.forward(
        params, inputs, cfg, return_hidden=cfg.mtp_depth > 0)
    loss = _xent(logits, labels)
    metrics = {"lm_loss": loss}
    if cfg.moe is not None:
        n_moe = max(1, sum(
            seg.repeats * sum(1 for s in seg.unit if s.mlp == "moe")
            for seg in cfg.segments))
        lb = aux["lb_loss"] / n_moe
        loss = loss + LB_LOSS_WEIGHT * lb
        metrics["lb_loss"] = lb
    if cfg.mtp_depth > 0:
        # DeepSeek-V3 MTP: predict token t+2 from [h_t ; emb(t+1)]
        h = aux["hidden"][:, :-1]                       # h_t, t < S-1
        nxt = inputs[:, 1:]                             # token t+1
        emb_nxt = layers.embedding_apply(params["embed"], nxt)
        h2 = torch.cat([h, emb_nxt], dim=-1) @ params["mtp"]["proj"]
        h2 = transformer._layer_apply(
            params["mtp"]["layer"], h2, cfg.segments[-1].unit[-1], cfg, {})
        h2 = layers.rmsnorm_apply(params["mtp"]["norm"], h2)
        logits2 = transformer._unembed(params, h2, cfg)
        mtp_loss = _xent(logits2, labels[:, 1:])
        loss = loss + MTP_LOSS_WEIGHT * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def input_specs(cfg: ModelConfig, shape: InputShape | str) -> dict:
    """Inputs of the step function of the given kind as ``meta`` tensors
    (the reference's ``ShapeDtypeStruct``s): token ids int32, embeddings
    in the model's dtype, a decode cell's cache in the port's layout (one
    entry per repeat, ``transformer.init_cache``)."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len

    def sds(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.frontend_stub:
            return {"embeds": sds((B, S, cfg.d_model), cfg.torch_dtype),
                    "labels": sds((B, S), torch.int32)}
        return {"tokens": sds((B, S + 1), torch.int32)}
    if shape.kind == "prefill":
        if cfg.frontend_stub:
            return {"embeds": sds((B, S, cfg.d_model), cfg.torch_dtype)}
        return {"tokens": sds((B, S), torch.int32)}
    if shape.kind == "decode":
        return {"token": sds((B,), torch.int32),
                "length": sds((), torch.int32),
                "cache": transformer.init_cache(cfg, B, S, "meta")}
    raise ValueError(shape.kind)


forward = transformer.forward
prefill = transformer.prefill
decode_step = transformer.decode_step
init_cache = transformer.init_cache
