"""Run configuration for the port.

``EDAConfig`` is the paper's deadline/early-stop technique, read by both
engines.  ``ModelConfig`` (with ``MoEConfig``, ``MLAConfig`` and YaRN's
``RopeScaling``) describes a language model the token engine serves;
architectures register themselves in ``repro_torch.configs`` and are
looked up with :func:`get_arch`.  ``ParallelConfig`` is the reference's, field for field
and default for default: the mesh fields (``data_axes``, ``model_axis``,
``fsdp``, ``fsdp_axes``, ``ep``, ``sp``, ``attn_batch_sharded``) feed
``repro_torch.sharding.rules``; ``train.train_step`` reads ``grad_accum``,
``remat``, ``use_kernels``, ``block_kv``, ``mxu_bf16`` and
``compress_grads``; ``launch.train`` reads ``opt_state_dtype`` for the
Adam moments.  ``scan_layers`` and ``donate_caches`` change nothing the
port computes (see their comments).  Benchmark and dry-run input shapes
are ``ShapeConfig`` instances (``SHAPES``), and :func:`cell_skip_reason`
says which (arch, shape) cells do not run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Optional


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Block kinds used by hybrid/ssm block patterns.
ATTN = "attn"
RGLRU = "rglru"
MLSTM = "mlstm"
SLSTM = "slstm"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    top_k: int = 0
    num_shared_experts: int = 0
    expert_ff: int = 0              # per-expert intermediate size
    first_dense_layers: int = 0     # leading layers that use the dense MLP
    router_aux_coef: float = 0.001  # load-balance aux loss coefficient
    # The port's own fields, which the reference lacks: kept out of the
    # repr, so that a config at their defaults reads as the reference's.
    # top-k gates renormalised to sum to 1 (False: the raw probabilities)
    norm_topk_prob: bool = field(default=True, repr=False)
    # expert capacity C = max(int(K * N * factor / E), 4) of a call over N
    # rows (GShard); None serves dropless, C = N
    capacity_factor: Optional[float] = field(default=1.25, repr=False)

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class RopeScaling:
    """YaRN's scaled rotary frequencies (arXiv:2309.00071, as DeepSeek-V2
    configures it): dimensions that turn fewer than ``beta_slow`` times
    over ``original_max_position`` are slowed by ``factor``, those that
    turn more than ``beta_fast`` times are kept, a linear ramp between.
    MLA's softmax scale gains ``yarn_mscale(factor, mscale_all_dim) ** 2``
    and the rotation ``mscale(mscale) / mscale(mscale_all_dim)``."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature ``0.1 * mscale * ln(factor) + 1`` (1 at
    no scaling)."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""
    q_lora_rank: int = 0            # 0 => dense q projection
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    attention: str = "full"         # full | sliding | mla
    window: int = 0                 # sliding window size (tokens)
    rope: bool = True
    rope_theta: float = 10_000.0
    # YaRN (the port's own field: out of the repr, as MoEConfig's)
    rope_scaling: Optional[RopeScaling] = field(default=None, repr=False)
    qkv_bias: bool = False
    o_bias: bool = False

    # --- block structure ---
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-6
    mlp: str = "swiglu"             # swiglu | geglu | gelu_mlp
    mlp_bias: bool = False
    parallel_block: bool = False    # attn and mlp share the residual read
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # Per-layer block kinds for ssm/hybrid families.  Empty => all ATTN.
    block_pattern: tuple = ()

    # --- MoE / MLA ---
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: Optional[MLAConfig] = None

    # --- recurrent (rglru / xlstm) ---
    conv_width: int = 4             # temporal conv width for RG-LRU blocks
    lru_width: int = 0              # 0 => d_model
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333
    mlstm_chunk: int = 64           # chunk length for chunkwise mLSTM

    # --- encoder-decoder (whisper-style) ---
    num_encoder_layers: int = 0
    encoder_seq: int = 1500         # stub frontend frame count

    # --- vlm ---
    num_patches: int = 0            # stub patch-embedding count

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- structure control ---
    # Kept so configurations read the same in both packages; the port
    # always runs its layers as a Python loop, so it has no effect here.
    unroll_layers: bool = False

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> tuple:
        """Resolved per-layer block kinds, length == num_layers."""
        if not self.block_pattern:
            return (ATTN,) * self.num_layers
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    # ------------------------------------------------------------------
    # Parameter counting (used for 6*N*D roofline and memory napkin math).
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        if self.attention == "mla":
            m = self.mla
            d = self.d_model
            n = 0
            if m.q_lora_rank:
                n += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * m.qk_head_dim
            else:
                n += d * self.num_heads * m.qk_head_dim
            n += d * (m.kv_lora_rank + m.qk_rope_dim)                    # kv_a
            n += m.kv_lora_rank * self.num_heads * (m.qk_nope_dim + m.v_head_dim)  # kv_b
            n += self.num_heads * m.v_head_dim * d                       # o
            return n
        n = self.d_model * (self.q_dim + 2 * self.kv_dim)                # qkv
        n += self.q_dim * self.d_model                                   # o
        if self.qkv_bias:
            n += self.q_dim + 2 * self.kv_dim
        return n

    def _dense_mlp_params(self, ff: int) -> int:
        mults = 3 if self.mlp in ("swiglu", "geglu") else 2
        return mults * self.d_model * ff

    def _moe_layer_params(self) -> tuple:
        """(total, active) params of one MoE layer."""
        m = self.moe
        per_expert = self._dense_mlp_params(m.expert_ff) // 1
        router = self.d_model * m.num_experts
        total = m.num_experts * per_expert + m.num_shared_experts * per_expert + router
        active = (m.top_k + m.num_shared_experts) * per_expert + router
        return total, active

    def _block_params(self, kind: str, layer_idx: int) -> tuple:
        """(total, active) params for one block of the given kind."""
        d = self.d_model
        if kind == ATTN:
            attn = self._attn_params()
            if self.moe.enabled and layer_idx >= self.moe.first_dense_layers:
                tot, act = self._moe_layer_params()
            else:
                tot = act = self._dense_mlp_params(self.d_ff)
            norms = 2 * d
            return attn + tot + norms, attn + act + norms
        if kind == RGLRU:
            w = self.lru_width or d
            # in/out proj (x + gate branches), conv, lru gates (a, input-gate)
            n = d * w * 2 + w * d + self.conv_width * w + 3 * w + 2 * w * (w // max(self.num_heads, 1)) // max(w // max(self.num_heads, 1), 1)
            n = d * w * 2 + w * d + self.conv_width * w + 3 * w
            n += 2 * w  # gate params (diagonal recurrences)
            mlpp = self._dense_mlp_params(self.d_ff) if self.d_ff else 0
            return n + mlpp + 2 * d, n + mlpp + 2 * d
        if kind == MLSTM:
            f = self.mlstm_proj_factor
            inner = int(d * f)
            n = d * inner * 2                 # up (x, gate)
            n += 3 * inner * inner            # q, k, v projections (inner space)
            n += 3 * inner                    # i, f gate projections + out skip
            n += inner * d                    # down
            return n + 2 * d, n + 2 * d
        if kind == SLSTM:
            # 4 gates, recurrent + input weights (block-diag by heads) + ffn
            heads = max(self.num_heads, 1)
            hd = d // heads
            n = 4 * d * d + 4 * heads * hd * hd + 4 * d
            f = self.slstm_proj_factor
            n += int(2 * d * d * f)
            return n + 2 * d, n + 2 * d
        raise ValueError(kind)

    def param_counts(self) -> tuple:
        """Returns (total_params, active_params) incl. embeddings."""
        total = active = 0
        for i, kind in enumerate(self.layer_kinds()):
            t, a = self._block_params(kind, i)
            total += t
            active += a
        emb = self.vocab_size * self.d_model
        total += emb
        active += emb
        if not self.tie_embeddings:
            total += emb
            active += emb
        if self.num_encoder_layers:
            enc = self.num_encoder_layers * self._block_params(ATTN, 0)[0]
            # cross attention in each decoder layer
            cross = self.num_layers * self._attn_params()
            total += enc + cross
            active += enc + cross
        total += self.d_model  # final norm
        active += self.d_model
        return int(total), int(active)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kinds = self.layer_kinds()
        # keep a representative prefix of the block pattern (>=1 of each kind)
        uniq = []
        for k in kinds:
            if k not in uniq:
                uniq.append(k)
        n_layers = max(2, len(uniq))
        pattern = tuple(uniq) if self.block_pattern else ()
        heads = 4
        kv = max(1, min(self.num_kv_heads, heads))
        if self.num_kv_heads == self.num_heads:
            kv = heads
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=16 if self.mla.q_lora_rank else 0,
                            kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
                            v_head_dim=8)
        moe = MoEConfig()
        if self.moe.enabled:
            moe = replace(self.moe, num_experts=4, top_k=2,
                          num_shared_experts=min(self.moe.num_shared_experts, 1),
                          expert_ff=32,
                          first_dense_layers=min(self.moe.first_dense_layers, 1))
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            window=min(self.window, 8) if self.window else 0,
            block_pattern=pattern,
            moe=moe,
            mla=mla,
            lru_width=64 if self.lru_width else 0,
            mlstm_chunk=8,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq=16,
            num_patches=4 if self.num_patches else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )


# ---------------------------------------------------------------------------
# Shapes (the assigned input-shape set; seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Parallelism (the reference's fields and defaults)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelConfig:
    data_axes: tuple = ("data",)     # batch-sharding axes (("pod","data") multi-pod)
    model_axis: str = "model"        # TP axis
    fsdp: bool = False               # shard params/opt-state over fsdp_axes
    fsdp_axes: tuple = ("data",)     # within-pod by default (cross-pod = pure DP)
    ep: bool = True                  # expert parallelism over model axis
    sp: bool = False                 # sequence-sharded inputs (train/prefill)
    remat: str = "none"              # none | full | dots (checkpointing)
    # the reference scans stacked layers when True; the port always loops
    # over per-layer parameters, so this changes nothing it computes
    scan_layers: bool = True
    grad_accum: int = 1              # microbatch count in train_step
    compress_grads: bool = False     # int8 all-reduce on the pod axis
    use_kernels: bool = False        # hand kernels (serving only: no backward)
    opt_state_dtype: str = "float32"  # bfloat16 halves Adam moment memory
    block_kv: int = 0                # blocked online-softmax chunk (0 = dense)
    attn_batch_sharded: bool = False  # q/k/v placed batch (+head) sharded
    # the reference donates the cache buffers to its jitted decode; the
    # port's caches update in place already, so this changes nothing
    donate_caches: bool = False
    mxu_bf16: bool = False           # bf16 attention operands, f32 products

    @property
    def batch_spec_axes(self):
        return tuple(self.data_axes) if len(self.data_axes) > 1 else self.data_axes[0]


# ---------------------------------------------------------------------------
# EDA (the paper's technique)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EDAConfig:
    esd: float = 0.0                 # early-stop divisor; 0/<=1 disables
    dynamic_esd: bool = False        # AIMD controller (paper §6 future work)
    esd_step: float = 0.25           # additive increase step for dynamic ESD
    segmentation: bool = False
    num_segments: int = 0            # 0 => auto (one per free worker)
    granularity_s: float = 1.0       # video segment length (paper: 1s / 2s)
    fps: int = 30
    download_overhead_s: float = 0.5 # paper-measured enqueue->start delay
    simulate_download_s: float = 0.35  # 1s-test simulated download (paper: 350ms)
    outer_priority: bool = True      # outer videos to strongest workers
    ewma_alpha: float = 0.3          # capacity estimator smoothing


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register_arch(name: str, fn: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = fn


def get_arch(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        import repro_torch.configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


# Which (arch, shape) cells are skipped and why (the reference's rule).
def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k":
        kinds = set(cfg.layer_kinds())
        subquad = (cfg.attention == "sliding" or kinds & {RGLRU, MLSTM, SLSTM})
        if not subquad:
            return "skipped: pure full-attention arch (long_500k needs sub-quadratic)"
    return None
