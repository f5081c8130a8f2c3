"""Analytic per-step cost model: FLOPs, HBM bytes, collective bytes.

The reference's ``runtime/cost_model.py``, moved unchanged: it reads the
model configs only, no framework, so its numbers are the reference's.

Why analytic: XLA's ``cost_analysis()`` counts a ``scan``/``while`` body
ONCE, not × trip-count (verified empirically — a 10-step scanned matmul
reports exactly 1/10th of the unrolled flops).  Every production model here
scans its layer stack, so HLO-derived totals undercount by ~num_layers.
The roofline therefore uses this analytic model (the same napkin math the
§Perf methodology demands), with the HLO numbers kept as a structural
cross-check (collective op *kinds/counts* are still read from the HLO).

All quantities are PER CHIP per step.  Ring-collective wire cost:
``2·(n−1)/n·size`` for all-reduce, ``(n−1)/n·size`` for all-gather /
reduce-scatter / all-to-all (uniform).
"""

from __future__ import annotations

import dataclasses

from ..configs.base import InputShape, LayerSpec, ModelConfig, SHAPES

BF16 = 2
F32 = 4


@dataclasses.dataclass
class ShardingAssumptions:
    """The layout the framework's rules produce (see runtime/sharding.py).

    The optional fields are the §Perf hillclimb knobs; each corresponds to
    a code-level feature (see EXPERIMENTS.md §Perf):
      weight_bytes      — serving weight quantization (2 = bf16, 1 = int8)
      kv_bytes          — KV-cache quantization
      a2a_bytes         — MoE dispatch payload dtype (2 = bf16, 1 = fp8)
      k_eff             — device-limited routing: expected distinct target
                          devices per token (DeepSeek node-limited routing);
                          0 = use top_k
      seq_parallel      — sequence-parallel norms: TP all-reduce becomes
                          reduce-scatter + all-gather (≈ half wire bytes)
      ep_serve          — decode-time expert placement over ALL chips:
                          weights stay resident, only activations move
    """
    dp: int                  # batch/FSDP ways (pod × data)
    tp: int                  # tensor/expert-parallel ways (model axis)
    fsdp_params: bool = True      # ZeRO-3 over dp (train) / 2-D serve
    remat: bool = False           # activation checkpointing (off: store all)
    dtype_bytes: int = BF16
    weight_bytes: int = BF16
    kv_bytes: int = BF16
    a2a_bytes: int = BF16
    k_eff: float = 0.0
    seq_parallel: bool = False
    ep_serve: bool = False


@dataclasses.dataclass
class StepCost:
    flops: float             # per chip
    hbm_bytes: float         # per chip
    coll_bytes: float        # per chip, on-wire
    breakdown: dict

    def roofline(self, peak=197e12, bw=819e9, link=50e9) -> dict:
        t_c = self.flops / peak
        t_m = self.hbm_bytes / bw
        t_l = self.coll_bytes / link
        dom = max((t_c, "compute"), (t_m, "memory"), (t_l, "collective"))[1]
        return {"t_compute_s": t_c, "t_memory_s": t_m,
                "t_collective_s": t_l, "dominant": dom,
                "bound_s": max(t_c, t_m, t_l)}


def _layer_param_count(cfg: ModelConfig, spec: LayerSpec,
                       active_only: bool) -> int:
    d = cfg.d_model
    p = 0
    if spec.mixer == "attn":
        p += d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        p += cfg.num_heads * cfg.head_dim * d
    elif spec.mixer == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        p += d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk
        p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
        p += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim
                                               + m.v_head_dim)
        p += cfg.num_heads * m.v_head_dim * d
    elif spec.mixer == "mamba":
        s = cfg.ssm
        p += d * 2 * s.d_inner + s.d_inner * (s.dt_rank + 2 * s.d_state)
        p += s.dt_rank * s.d_inner + s.d_inner * d
    elif spec.mixer == "rwkv":
        p += 5 * d * d + 2 * d * cfg.rwkv_decay_lora
    if spec.mlp == "dense":
        p += (3 if cfg.act == "silu" else 2) * d * cfg.d_ff
    elif spec.mlp == "moe":
        m = cfg.moe
        n_e = m.top_k if active_only else m.num_experts
        p += d * m.num_experts  # router
        p += (n_e + m.num_shared) * 3 * d * m.d_ff
    elif spec.mlp == "rwkv_cmix":
        p += 2 * d * int(3.5 * d) + d * d
    return p


def _iter_layers(cfg: ModelConfig):
    for seg in cfg.segments:
        for _ in range(seg.repeats):
            for spec in seg.unit:
                yield spec


def step_cost(cfg: ModelConfig, shape: InputShape | str,
              sh: ShardingAssumptions) -> StepCost:
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    T = B * (1 if decode else S)          # tokens this step (global)
    T_c = T / sh.dp                        # per-chip tokens
    ctx = S if decode else S               # attention context length
    d = cfg.d_model
    dt = sh.dtype_bytes
    fwd_bwd = 3.0 if train else 1.0        # bwd ≈ 2× fwd matmul flops

    flops = 0.0
    hbm = 0.0
    coll = 0.0
    bd: dict = {}

    # ---- per-layer projection flops (≈ 2·tokens·params_active) ------------
    proj_params = sum(_layer_param_count(cfg, spec, active_only=True)
                      for spec in _iter_layers(cfg))
    flops += fwd_bwd * 2 * T_c * (proj_params / sh.tp)
    bd["proj_flops"] = flops

    # ---- attention quadratic + SSM scan flops ------------------------------
    attn_layers = sum(1 for s in _iter_layers(cfg) if s.mixer in
                      ("attn", "mla"))
    ssm_layers = sum(1 for s in _iter_layers(cfg) if s.mixer in
                     ("mamba", "rwkv"))
    hd_qk = (cfg.head_dim if cfg.mla is None
             else cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)
    hd_v = cfg.head_dim if cfg.mla is None else cfg.mla.v_head_dim
    causal_frac = 0.5 if not decode else 1.0
    qd_flops = (2 * T_c * ctx * causal_frac * cfg.num_heads
                * (hd_qk + hd_v) * attn_layers / sh.tp)
    flops += fwd_bwd * qd_flops
    bd["attn_quadratic_flops"] = fwd_bwd * qd_flops
    if ssm_layers and cfg.ssm is not None:
        s = cfg.ssm
        ssm_flops = 6 * T_c * s.d_inner * s.d_state * ssm_layers / sh.tp
        flops += fwd_bwd * ssm_flops
    if ssm_layers and cfg.rwkv_heads:
        hd = d // cfg.rwkv_heads
        flops += fwd_bwd * 4 * T_c * d * hd * ssm_layers / sh.tp

    # ---- logits -------------------------------------------------------------
    logit_flops = 2 * T_c * d * cfg.vocab_size / sh.tp
    flops += fwd_bwd * logit_flops
    bd["logit_flops"] = fwd_bwd * logit_flops

    # ---- HBM bytes ----------------------------------------------------------
    n_params = cfg.param_count()
    param_shards = sh.dp * sh.tp if sh.fsdp_params else sh.tp
    params_chip = n_params * sh.weight_bytes / param_shards
    if train:
        # fwd read + bwd read + grad write (bf16) + m/v read+write (f32×2×2)
        hbm += params_chip * 3 + (n_params / (sh.dp * sh.tp)) * F32 * 4
        hbm += params_chip  # param write
    elif sh.ep_serve:
        # experts resident on their home chip (sharded over ALL chips);
        # only the touched expert rows + non-expert shard stream per step
        hbm += n_params * sh.weight_bytes / (sh.dp * sh.tp)
    elif sh.fsdp_params:
        # 2-D serve: read own shard + write/read the gathered remainder
        gathered = n_params * sh.weight_bytes / sh.tp - params_chip
        hbm += params_chip + 2 * gathered
    else:
        hbm += params_chip  # stream the TP shard once
    bd["param_bytes"] = hbm

    n_layers = cfg.num_layers
    act_traffic = T_c * d * dt * n_layers * (4 if not sh.remat else 6)
    hbm += act_traffic * (2 if train else 1)
    bd["act_bytes"] = act_traffic

    if decode:
        # KV-cache read per step (the dominant stream)
        cache_bytes = 0.0
        for spec in _iter_layers(cfg):
            if spec.mixer == "attn":
                cache_bytes += (2 * cfg.num_kv_heads * cfg.head_dim
                                * ctx * B * sh.kv_bytes)
            elif spec.mixer == "mla":
                m = cfg.mla
                cache_bytes += ((m.kv_lora_rank + m.qk_rope_head_dim)
                                * ctx * B * sh.kv_bytes)
            elif spec.mixer == "mamba":
                cache_bytes += (cfg.ssm.d_inner * cfg.ssm.d_state * B * F32)
            elif spec.mixer == "rwkv":
                hd = d // cfg.rwkv_heads
                cache_bytes += cfg.rwkv_heads * hd * hd * B * F32
        hbm += cache_bytes / (sh.dp * sh.tp)
        bd["cache_bytes_chip"] = cache_bytes / (sh.dp * sh.tp)
    elif cfg.moe is None or True:
        # prefill/train logits materialization
        hbm += T_c * cfg.vocab_size * F32 / sh.tp
        bd["logit_bytes"] = T_c * cfg.vocab_size * F32 / sh.tp

    # ---- collectives --------------------------------------------------------
    tp, dp = sh.tp, sh.dp
    if tp > 1:
        # Megatron: 2 activation all-reduces per layer fwd (+2 bwd);
        # sequence-parallel replaces each AR with RS+AG (half wire bytes)
        ar = 2 * (tp - 1) / tp * (T_c * d * dt)
        if sh.seq_parallel:
            ar = ar / 2
        n_ar = 2 * n_layers * (2 if train else 1)
        coll += n_ar * ar
        bd["tp_allreduce_bytes"] = n_ar * ar
    if cfg.moe is not None:
        # EP all-to-all dispatch+combine (fwd [+bwd]).  Payload dtype and
        # device-limited routing both shrink wire bytes.
        k_wire = sh.k_eff if sh.k_eff > 0 else float(cfg.moe.top_k)
        ep_ways = (dp * tp) if sh.ep_serve else tp
        a2a = 2 * (ep_ways - 1) / ep_ways * (T_c * d * sh.a2a_bytes) * k_wire
        n_moe = sum(1 for s in _iter_layers(cfg) if s.mlp == "moe")
        coll += n_moe * a2a * (2 if train else 1)
        bd["moe_a2a_bytes"] = n_moe * a2a * (2 if train else 1)
    if train and dp > 1:
        # ZeRO-3: AG params fwd + AG bwd + RS grads; ring wire bytes per
        # chip = 3 · (dp−1)/dp · local_shard, local_shard = params·dt/(dp·tp)
        fsdp = 3 * (dp - 1) / dp * (n_params * dt / (tp * dp))
        coll += fsdp
        bd["fsdp_bytes"] = fsdp
    if (not train) and sh.fsdp_params and not sh.ep_serve:
        # 2-D serve layout must gather the dp-sharded weights each step
        ag = (dp - 1) / dp * (n_params * sh.weight_bytes / (dp * tp)) * dp
        coll += ag
        bd["serve_weight_ag_bytes"] = ag

    return StepCost(flops, hbm, coll, bd)


def cost_for_cell(cfg: ModelConfig, shape: InputShape | str,
                  *, n_pods: int = 1, remat: bool = False,
                  serve_policy: str | None = None) -> StepCost:
    """Cost under the framework's default sharding for the standard mesh."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    dp = 16 * n_pods
    tp = 16
    train = shape.kind == "train"
    if serve_policy is None:
        pbytes = cfg.param_count() * BF16
        serve_policy = ("2d" if pbytes / tp > 0.5 * 16 * 2**30 else "tp")
    # batch must actually shard dp ways; clamp for tiny batches (long_500k)
    eff_dp = min(dp, shape.global_batch) if shape.kind != "train" else dp
    eff_dp = max(1, eff_dp)
    sh = ShardingAssumptions(
        dp=eff_dp, tp=tp,
        fsdp_params=(True if train else serve_policy == "2d"),
        remat=remat)
    return step_cost(cfg, shape, sh)
