"""Sharding rules: logical param/activation axes → per-dim mesh axes, and
those as DTensor placements.  The card's constants live here too.

The port of the reference's ``runtime/sharding.py``.  The production
mesh is fixed — ``(data, model)`` in-pod, ``(pod, data, model)`` across
pods — and ten very different architectures must place on it.  Rules are
*adaptive*: each states a preference list of mesh axes per tensor
dimension, and :func:`safe_spec` keeps an axis only if it divides the
dimension (and is not already used), falling back to replication.

A *spec* is the port's own stand-in for the reference's
``PartitionSpec``: a tuple with one entry per leading tensor dim — an
axis name, a tuple of axis names (the dim split over several axes,
major first), or ``None`` — with trailing ``None`` dropped, as ``P``
drops them.  The spec functions read only the mesh's axis sizes (a
``{name: size}`` mapping or a ``DeviceMesh``), so they run with no
process group; :func:`to_placements` turns a spec into the DTensor
placements of a ``DeviceMesh`` whose dims are named ``("data",
"model")`` or ``("pod", "data", "model")``.

The port's trees keep one entry per repeat of a segment
(``segment_<i>[repeat][unit]``) where the reference stacks the repeats
on a leading axis and prefixes ``None`` to a ``segment_*`` leaf's spec:
here each repeat's leaf gets that spec without the leading ``None``.

Layout summary (train): FSDP over ``data`` on one dim of a weight and
Megatron TP over ``model`` on the other; experts over ``model`` on the
expert dim; batches over (``pod``, ``data``).  Serve: weights TP-only
when a ``model`` shard fits half of HBM, 2-D otherwise
(:func:`serve_weight_policy`); KV caches over batch and heads (or
sequence when the head count does not divide the axis).
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Mapping, Sequence

import torch

from .. import tree

# -- the card's constants ----------------------------------------------------
# NVIDIA H100 80GB HBM3 (SXM).  HBM: what
# ``torch.cuda.get_device_properties(0).total_memory`` reads on that card
# (85,017,493,504 B; NVIDIA H100 80GB HBM3 at a 700 W power limit).
HBM_BYTES_PER_CHIP = 85_017_493_504
#: dense bf16 tensor-core peak, NVIDIA's H100 SXM data sheet
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth, NVIDIA's H100 SXM data sheet
HBM_BW = 3.35e12
#: A mesh axis has 16 ranks, which spans two 8-GPU NVLink domains, so a
#: ring over it is bounded by the inter-node link: one 400 Gb/s NDR
#: InfiniBand adapter per GPU (NVIDIA DGX H100 user guide, "8x NVIDIA
#: ConnectX-7 400Gb/s"), 50 GB/s a GPU a direction.
ICI_BW_PER_LINK = 50e9

Spec = tuple

#: when set (by the launcher) to the data-parallel axis names, the model
#: code applies sequence-parallel activation constraints (the reference's
#: §Perf B3): residual activations shard (batch→dp, seq→model) between
#: blocks, so each TP all-reduce becomes reduce-scatter + all-gather.
_SP_AXES: contextvars.ContextVar = contextvars.ContextVar(
    "sp_axes", default=None)


def sequence_parallel_axes():
    return _SP_AXES.get()


class sequence_parallel:
    """Context manager enabling the SP constraints while a step runs."""

    def __init__(self, dp_axes=("data",), tp_axis="model"):
        self.value = (tuple(dp_axes), tp_axis)

    def __enter__(self):
        self._token = _SP_AXES.set(self.value)
        return self

    def __exit__(self, *exc):
        _SP_AXES.reset(self._token)
        return False


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor.  A plain tensor answers at once, without
    reaching ``torch.distributed.tensor``: the model code asks on every
    layer of every step."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def sp_constrain(x):
    """Redistribute a 3-D DTensor residual to batch over dp and sequence
    over tp under :class:`sequence_parallel`; anything else as it is."""
    axes = _SP_AXES.get()
    if axes is None or x.ndim != 3 or not is_dtensor(x):
        return x
    dp_axes, tp = axes
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return x.redistribute(x.device_mesh,
                          to_placements(x.device_mesh, (dp, tp, None)))


def constrain_residual(x):
    """The residual stream's layout between layers, on a DTensor: batch
    over the data-parallel axes (:func:`batch_pspec`), or, under
    :class:`sequence_parallel`, :func:`sp_constrain`'s.  A plain tensor
    passes unchanged.  Pinning it gives every layer its input in one
    layout, where DTensor's own choices drift from layer to layer (and
    its planning of the odd layouts costs minutes on a 3-D mesh)."""
    if not is_dtensor(x):
        return x
    if _SP_AXES.get() is not None:
        return sp_constrain(x)
    mesh = x.device_mesh
    target = to_placements(mesh, batch_pspec(mesh, x.shape))
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


# -- mesh sizes and the spec rules -------------------------------------------

def mesh_sizes(mesh: Any) -> dict[str, int]:
    """``{axis name: size}`` of a mapping or a ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: Any, axis) -> int:
    sizes = mesh_sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def safe_spec(mesh: Any, shape: Sequence[int],
              prefs: Sequence[Any]) -> Spec:
    """A spec keeping only divisible, unused axes.

    ``prefs[i]`` is an axis name, a tuple of axis names, a list of
    *candidate* axes (first that fits wins), or None.
    """
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    out: list[Any] = []
    for dim, pref in zip(shape, list(prefs) + [None] * (len(shape)
                                                        - len(prefs))):
        cands = pref if isinstance(pref, list) else [pref]
        chosen = None
        for cand in cands:
            if cand is None:
                continue
            names = cand if isinstance(cand, tuple) else (cand,)
            if any(n in used for n in names):
                continue
            if all(n in sizes for n in names) and dim % axis_size(
                    sizes, cand) == 0 and axis_size(sizes, cand) > 1:
                chosen = cand
                used.update(names)
                break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical roles of the physical mesh axes."""
    dp: Any = ("data",)          # batch / FSDP axes (may include "pod")
    tp: str = "model"            # tensor/expert-parallel axis

    @property
    def dp_spec(self):
        return tuple(self.dp) if len(self.dp) > 1 else self.dp[0]


def mesh_axes_for(mesh: Any) -> MeshAxes:
    if "pod" in mesh_sizes(mesh):
        return MeshAxes(dp=("pod", "data"), tp="model")
    return MeshAxes(dp=("data",), tp="model")


# name-keyed rules: the LAST path component → dim prefs, where "IN" is
# the FSDP axis (data) and "OUT" the TP axis (model)
_COL = ("IN", "OUT")     # column-parallel: (d_in, d_out·TP)
_ROW = ("OUT", "IN")     # row-parallel:    (d_in·TP, d_out)

_PARAM_RULES: dict[str, tuple] = {
    # embeddings: vocab over TP, features over FSDP
    "table": ("OUT", "IN"),
    # attention
    "w_q": _COL, "w_k": _COL, "w_v": _COL, "w_o": _ROW,
    "b_q": ("OUT",), "b_k": ("OUT",), "b_v": ("OUT",),
    # MLA
    "w_dq": _COL, "w_uq": _COL, "w_dkv": _COL, "w_ukv": _COL,
    # MLP
    "w_up": _COL, "w_gate": _COL, "w_down": _ROW,
    # MoE (the leading expert dim is told by shape: 3-D tensors)
    "router": ("IN", None),
    # Mamba
    "w_in": _COL, "w_x": _COL, "w_dt": ("IN", "OUT"), "w_out": _ROW,
    "conv_w": (None, "OUT"), "conv_b": ("OUT",),
    "A_log": ("OUT", None), "D": ("OUT",), "dt_bias": ("OUT",),
    # RWKV
    "w_r": _COL, "w_g": _COL, "decay_A": _COL, "decay_B": _ROW,
    "decay_w0": ("OUT",), "bonus_u": (None, None),
    "mu_r": (), "mu_k": (), "mu_v": (), "mu_w": (), "mu_g": (),
    # misc
    "proj": _COL,
    "scale": (), "bias": (),
}

_EXPERT = ("w_gate", "w_up", "w_down")


def _resolve(pref, axes: MeshAxes):
    if pref == "IN":
        return [axes.dp_spec, None]
    if pref == "OUT":
        return [axes.tp, None]
    return [pref]


def _last(path: tuple) -> str:
    return str(path[-1]) if path else ""


def param_pspec(mesh: Any, path: tuple, leaf: Any,
                axes: MeshAxes | None = None) -> Spec:
    """The spec of one parameter leaf given its path in the port's tree
    (one repeat's leaf under ``segment_<i>``)."""
    axes = axes or mesh_axes_for(mesh)
    last = _last(path)
    rule = _PARAM_RULES.get(last)
    if rule is None:
        return ()  # replicate unknowns (safe default)
    shape = tuple(leaf.shape)
    # MoE expert tensors: 3-D (E, in, out), expert-parallel on dim 0
    if len(shape) == 3 and last in _EXPERT:
        prefs = [[axes.tp, None], [axes.dp_spec, None], [None]]
    else:
        prefs = [_resolve(p, axes) for p in rule[:len(shape)]]
    return safe_spec(mesh, shape, prefs)


def batch_pspec(mesh: Any, shape: Sequence[int],
                axes: MeshAxes | None = None) -> Spec:
    """Token batches: batch dim over (pod, data), else data, else
    replicated."""
    axes = axes or mesh_axes_for(mesh)
    ndim = len(shape)
    if ndim == 0:
        return ()
    prefs: list = [[axes.dp_spec, axes.dp[-1], None]]
    if ndim >= 2:
        prefs.append([None])
    return safe_spec(mesh, shape, prefs)


def cache_pspec(mesh: Any, path: tuple, leaf: Any,
                axes: MeshAxes | None = None) -> Spec:
    """KV / state caches, by the leaf's name and rank."""
    axes = axes or mesh_axes_for(mesh)
    last = _last(path)
    core = tuple(leaf.shape)
    dp = [axes.dp_spec, axes.dp[-1], None]

    if last in ("k", "v") and len(core) == 4:        # (B, Hkv, S, hd)
        prefs = [dp, [axes.tp, None], [axes.tp, None], [None]]
    elif last in ("c_kv", "k_pe") and len(core) == 3:  # (B, S, r)
        prefs = [dp, [axes.tp, None], [None]]
    elif last == "h" and len(core) == 3:             # (B, dI, N)
        prefs = [dp, [axes.tp, None], [None]]
    elif last == "conv" and len(core) == 3:          # (B, K-1, dI)
        prefs = [dp, [None], [axes.tp, None]]
    elif last == "S" and len(core) == 4:             # (B, H, hd, hd)
        prefs = [dp, [axes.tp, None], [None], [None]]
    else:
        prefs = [dp] + [[None]] * (len(core) - 1)
    return safe_spec(mesh, core, prefs)


def tree_specs(mesh: Any, tree_: Any, spec_fn) -> Any:
    """``spec_fn(mesh, path, leaf)`` over a tree's leaves, in its
    structure."""
    pairs = tree.flatten_with_paths(tree_)
    return tree.unflatten(tree_, [spec_fn(mesh, p, leaf)
                                  for p, leaf in pairs])


def params_specs(mesh: Any, params: Any,
                 axes: MeshAxes | None = None) -> Any:
    """The train layout of a parameter tree."""
    axes = axes or mesh_axes_for(mesh)
    return tree_specs(mesh, params,
                      lambda m, p, leaf: param_pspec(m, p, leaf, axes))


# -- serving weight policy ---------------------------------------------------

def serve_weight_policy(param_bytes: int, mesh: Any, *,
                        budget_frac: float = 0.5,
                        hbm_bytes: int = HBM_BYTES_PER_CHIP) -> str:
    """"tp" when one TP shard of the weights fits in ``budget_frac`` of
    ``hbm_bytes`` (no per-step weight gathering at decode), else "2d"
    (FSDP + TP)."""
    tp = mesh_sizes(mesh).get("model", 1)
    if param_bytes / tp <= budget_frac * hbm_bytes:
        return "tp"
    return "2d"


def params_specs_serve(mesh: Any, params: Any, param_bytes: int, *,
                       ep_serve: bool = False,
                       hbm_bytes: int = HBM_BYTES_PER_CHIP) -> Any:
    """Serving layouts.

    * ``tp``  — weights over ``model`` only (small models): no per-step
      weight movement.
    * ``2d``  — FSDP + TP (big models): fits, but gathers weights each
      step.
    * ``ep_serve`` — expert tensors over ALL axes on the expert dim:
      weights stay resident and only token activations cross the wire.
    """
    policy = serve_weight_policy(param_bytes, mesh, hbm_bytes=hbm_bytes)
    axes = mesh_axes_for(mesh)
    tp_axes = MeshAxes(dp=("_none_",), tp=axes.tp)
    all_axes = tuple(a for a in ("pod", "data", "model")
                     if a in mesh_sizes(mesh))

    def spec(m, path, leaf):
        if ep_serve and leaf.ndim == 3 and _last(path) in _EXPERT:
            return safe_spec(m, leaf.shape,
                             [[all_axes, axes.tp], [None], [None]])
        return param_pspec(m, path, leaf,
                           axes if policy == "2d" else tp_axes)

    return tree_specs(mesh, params, spec)


# -- placements --------------------------------------------------------------

def to_placements(mesh: Any, spec: Spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on
    each mesh dim that splits tensor dim ``i``, ``Replicate()`` on the
    others.  A dim split over a tuple of axes is split major first, as
    JAX splits it; DTensor splits a tensor dim over several mesh dims in
    mesh-dim order, so the tuple must name them in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes_ = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes_]
        if dims != sorted(dims):
            raise ValueError(f"tensor dim {i} splits over {axes_}, not in "
                             f"the mesh's order {tuple(names)}")
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)


class NamedSharding:
    """Where one tensor lives: a ``DeviceMesh`` and the tensor's DTensor
    placements on it — the reference's ``jax.sharding.NamedSharding``
    (a mesh and a ``PartitionSpec``).  Neither a tuple nor a dataclass,
    so ``tree`` takes it for one leaf and a tree of them aligns with the
    tree of tensors it places."""

    __slots__ = ("mesh", "placements")

    def __init__(self, mesh: Any, placements: Sequence[Any]):
        self.mesh = mesh
        self.placements = tuple(placements)

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh == self.mesh
                and other.placements == self.placements)

    def __hash__(self) -> int:
        return hash((self.mesh, self.placements))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.placements!r})"

    def distribute(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (whole, on any device) as a DTensor on this rank's device
        of the mesh, each rank keeping its own chunk: no communication
        (``src_data_rank=None``), so every rank must pass the same
        ``t``."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


def local_shape(mesh: Any, shape: Sequence[int], spec: Spec) -> tuple:
    """The shape of one rank's chunk (the rules keep only dividing axes,
    so every rank's chunk has it)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            n = axis_size(mesh, entry)
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                 f"divide over {entry} ({n})")
            out[i] //= n
    return tuple(out)
