"""Three-term roofline from a counted step (NVIDIA H100 target).

    compute    = FLOPs            / peak_FLOPs
    memory     = bytes accessed   / HBM_bw
    collective = collective_bytes / link_bw

All three are **per device**, as in the reference (whose
``compiled.cost_analysis()`` reports the SPMD-partitioned module).  Nothing
is compiled here: :class:`CountMode`, a ``TorchDispatchMode``, counts what
runs.  A mode sits above DTensor, so it first sees each op with the global
shapes; it steps aside there (``NotImplemented``), DTensor runs the op on
each rank's local shards, and the mode counts those local ops:

  - FLOPs by ``torch.utils.flop_counter``'s formulas on the local shapes;
  - bytes accessed: each op's tensor inputs and outputs, views and
    allocations excluded (eager runs every op unfused, so this is larger
    than XLA's count of a fused program);
  - collective operand bytes of every ``_c10d_functional`` collective
    (``all_gather_into_tensor``, ``all_reduce``, ``reduce_scatter_tensor``,
    ``all_to_all_single``: DTensor's redistributions), of the ``c10d``
    collectives a caller runs directly, and of each point-to-point send
    (the pipeline's ring shift), under the reference's five keys.

DTensor infers an output's global shape by running the op once on fake
global-shape arguments that it allocates first; the mode skips that run.
Ring-algorithm wire factors (2 for all-reduce, 1 otherwise, the n >> 1
values) are folded into the collective term.

``model_flops`` (``6·N·D`` dense, ``6·N_active·D`` MoE),
``estimate_memory_per_device`` and ``_cache_bytes`` are the reference's
arithmetic, verbatim.  ``HW_H100`` takes its rates from the NVIDIA H100
SXM datasheet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import ModelConfig, ShapeConfig

# ---------------------------------------------------------------------------
# Hardware constants
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float            # bf16 dense FLOP/s per chip
    hbm_bw: float                # bytes/s per chip
    link_bw: float               # bytes/s per link direction
    hbm_bytes: float             # capacity per chip


# NVIDIA H100 SXM datasheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3,
# NVLink 900 GB/s bidirectional (450 GB/s a direction), 80 GB.
HW_H100 = HardwareSpec("NVIDIA H100 80GB HBM3", peak_flops=989e12,
                       hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9)
H100_SMS = 132                   # the SXM part's SMs

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# wire-traffic factor per collective for ring algorithms on n participants;
# evaluated at the asymptotic n>>1 value (16..256 here)
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# op name (``_c10d_functional`` and ``c10d`` namespaces) -> key
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
# ops that move nothing: allocation, metadata, waits, the recv half of a
# send (counted on the send)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "device", "sym_size", "sym_stride",
               "sym_numel", "sym_storage_offset", "wait_tensor", "recv_",
               "recv_any_source_", "barrier", "broadcast_", "detach",
               "lift_fresh", "_local_scalar_dense", "is_same_size"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(ts) -> int:
    seen, n = set(), 0
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            n += t.numel() * t.element_size()
    return n


class CountMode(TorchDispatchMode):
    """Per-device FLOPs, bytes accessed and collective operand bytes of
    what runs under it (see the module docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, int] = {c: 0 for c in COLLECTIVES}
        self._prop = None            # (op, allocations) after a DTensor op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed._functional_collectives import \
            AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, (DTensor, AsyncCollectiveTensor))
               for t in types):
            # DTensor (or the collective's wrapper) runs the local ops
            self._prop = (func, 0)
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name == "empty_strided" and self._prop is not None:
            self._prop = (self._prop[0], self._prop[1] + 1)
            return out
        prop, self._prop = self._prop, None
        if prop is not None and prop[1] > 0 and func == prop[0]:
            return out               # DTensor's global-shape inference run
        self._count(func, name, args, kwargs, out)
        return out

    def _count(self, func, name, args, kwargs, out) -> None:
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d"):
            key = _COLLECTIVE_OPS.get(name)
            if key is not None:
                src = args[0] if args else ()
                self.coll[key] += _nbytes(_tensors(src))
            return
        if name in _NO_TRAFFIC or ns == "prim":
            return
        from torch.utils.flop_counter import flop_registry
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += int(f(*args, **kwargs, out_val=out))
        if func.is_view:
            return
        self.bytes += _nbytes(list(_tensors(args)) + list(_tensors(kwargs))
                              + list(_tensors(out)))

    def cost(self) -> dict:
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes)}


def collective_bytes(counter: CountMode, per_op: bool = False):
    """Operand bytes of the collectives a :class:`CountMode` saw: the
    total, or a dict under the reference's five keys when ``per_op``."""
    if per_op:
        return dict(counter.coll)
    return sum(counter.coll.values())


# ---------------------------------------------------------------------------
# Model FLOPs (6*N*D)
# ---------------------------------------------------------------------------


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D with N = active params; D = tokens processed by the step.

    decode steps process global_batch tokens (one per sequence) and the
    multiplier is 2·N (forward only); train is 6·N·D; prefill 2·N·D.
    """
    _total, active = cfg.param_counts()
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch          # decode: 1 token/seq


# ---------------------------------------------------------------------------
# Analytic per-device memory (fit check)
# ---------------------------------------------------------------------------


def estimate_memory_per_device(cfg: ModelConfig, shape: ShapeConfig,
                               tp: int, dp: int, fsdp: bool,
                               grad_accum: int = 1,
                               remat: str = "full",
                               opt_state_dtype: str = "float32") -> dict:
    """First-principles HBM bytes per device (the reference's model: it
    counts fp32 gradients at 4 B a parameter)."""
    total, _ = cfg.param_counts()
    pbytes = 2 * total / tp                       # bf16 weights, TP-sharded
    opt = 0.0
    act = 0.0
    cache = 0.0
    if shape.kind == "train":
        mom = 4 if opt_state_dtype == "float32" else 2
        opt = (4 + 2 * mom) * total / tp          # fp32 grads + mu + nu
        if fsdp:
            opt /= dp
            pbytes = pbytes / dp + 2 * total / tp / 8  # shard + gather buf
        b_local = shape.global_batch / dp / grad_accum
        resid = b_local * shape.seq_len * cfg.d_model * 2
        if remat == "full":
            act = resid * cfg.num_layers          # layer-boundary saves
        elif remat == "dots":
            act = resid * cfg.num_layers * 8      # ~8 dot outputs/layer
        else:
            act = resid * cfg.num_layers * 16     # everything
        # fp32 logits for the live microbatch (vocab TP-sharded when even)
        vshard = tp if cfg.vocab_size % tp == 0 else 1
        act += b_local * shape.seq_len * cfg.vocab_size * 4 / vshard
    elif shape.kind == "prefill":
        b_local = shape.global_batch / dp
        act = b_local * shape.seq_len * cfg.d_model * 2 * 4   # working set
        cache = _cache_bytes(cfg, shape, tp, dp)
    else:
        cache = _cache_bytes(cfg, shape, tp, dp)
        act = 64e6
    return {"params": pbytes, "opt": opt, "activations": act, "cache": cache,
            "total": pbytes + opt + act + cache}


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                 dp: int) -> float:
    """KV/recurrent cache bytes per device (seq or batch sharded over the
    whole mesh, matching ``repro_torch.sharding.rules.cache_pspecs``)."""
    from repro_torch.config import ATTN, MLSTM, RGLRU, SLSTM
    chips = tp * dp
    B, S = shape.global_batch, shape.seq_len
    per_layer = 0.0
    for kind in cfg.layer_kinds():
        if kind == ATTN:
            if cfg.attention == "mla":
                per_layer += B * S * (cfg.mla.kv_lora_rank
                                      + cfg.mla.qk_rope_dim) * 2
            else:
                cap = min(S, cfg.window) if cfg.window else S
                per_layer += B * cap * cfg.kv_dim * 2 * 2
        elif kind == RGLRU:
            w = cfg.lru_width or cfg.d_model
            per_layer += B * w * 4 + B * (cfg.conv_width - 1) * w * 2
        elif kind == MLSTM:
            inner = int(cfg.d_model * cfg.mlstm_proj_factor)
            dh = inner // cfg.num_heads
            per_layer += B * cfg.num_heads * (dh * dh + dh + 1) * 4
        elif kind == SLSTM:
            per_layer += 4 * B * cfg.d_model * 4
    return per_layer / chips                      # fully sharded over mesh


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_by_op: dict
    model_flops_: float
    hw: HardwareSpec = field(default=HW_H100)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: overlapped terms -> max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """useful (6ND) flops / counted flops, both whole-program."""
        if not self.flops:
            return 0.0
        return self.model_flops_ / (self.flops * self.chips)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the hardware roofline this step achieves, counting
        only useful (6ND) FLOPs: (model_flops / peak) / step_s, at the
        report's own hardware."""
        if self.step_s <= 0:
            return 0.0
        ideal = self.model_flops_ / (self.chips * self.hw.peak_flops)
        return ideal / self.step_s

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": f"{self.compute_s:.3e}",
            "memory_s": f"{self.memory_s:.3e}",
            "collective_s": f"{self.collective_s:.3e}",
            "dominant": self.dominant,
            "useful_ratio": f"{self.useful_ratio:.2f}",
            "roofline_frac": f"{self.roofline_fraction:.3f}",
        }


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int, hw: HardwareSpec = HW_H100):
    """All three inputs are PER-DEVICE quantities; ``chips`` is kept in
    the signature for the global-input form: pass global values and they
    divide through identically."""
    return (flops / hw.peak_flops,
            bytes_accessed / hw.hbm_bw,
            coll_bytes / hw.link_bw)


def analyse_counted(arch: str, shape_cfg: ShapeConfig, mesh_name: str,
                    chips: int, cost: dict, coll_by_op: dict,
                    cfg: ModelConfig,
                    hw: HardwareSpec = HW_H100) -> RooflineReport:
    """Build the report from a :class:`CountMode`'s per-device ``cost()``
    and ``collective_bytes(..., per_op=True)``."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll = sum(_WIRE_FACTOR[k] * v for k, v in coll_by_op.items())
    r = RooflineReport(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        flops=flops, bytes_accessed=byts, coll_bytes=float(coll),
        coll_by_op=dict(coll_by_op),
        model_flops_=model_flops(cfg, shape_cfg), hw=hw)
    r.compute_s, r.memory_s, r.collective_s = roofline_terms(
        flops, byts, coll, chips, hw)
    return r
