"""Continuous-batching LM serving engine with the paper's deadline policy.

Counterpart of the reference's ``serving/engine.py``: a chunked-prefill-
and-decode workload shell over the shared :class:`EngineCore` (the same
substrate the vision engine rides).  The engine owns ``slots`` decode lanes
(slot = one request's cache row: KV ring and, for the RG-LRU and xLSTM
stacks, recurrent state).  Each request is

  1. *segmented* — its prompt is prefilled in descending power-of-two
     chunks (the paper's segmentation as chunked prefill),
  2. *admitted* — written into a free slot's cache (contiguous: the 1-row
     prefill cache is copied in place with ``insert_row``; paged: the
     chunks write straight into the shared pool through the slot's table
     row),
  3. *decoded* — one token per engine tick for every active slot,
  4. *early-stopped* — a token budget derived from its deadline through
     the core's ESD policy at the engine's EWMA per-tick cost,
  5. *ledgered* — closed into a ``telemetry.SegmentRecord``.

Priority classes mirror outer/inner: ``priority=0`` (hazard) requests jump
the admission queue of ``priority=1`` (distraction) requests, with a
bounded-bypass aging pop.  Timing flows through the ``core.clock`` seam:
decode ticks charge ``TOKEN`` work and prefill chunks ``PREFILL`` work, so
under a ``VirtualClock`` turnaround and TTFT are deterministic.

KV layout: contiguous per-slot rings (``paged=False``) or the paged block
pool (the default wherever ``transformer.paged_eligible`` holds: GQA's
K/V, or MLA's latents, which the reference serves contiguously only), with
a host-side :class:`BlockPool` and a per-slot block table; a
sliding-window arch rings at block granularity, ``ceil((window-1)/bs) +
1`` columns.
Stacks with recurrent layers (recurrentgemma-9b, xlstm-350m) are
contiguous only: each admission prefills a fresh 1-row ``init_caches``
row (sentinels included) and ``insert_row`` copies its dict states in at
batch axis 0.  Prompts are never padded: a padded tail would corrupt the
recurrent state.

The encoder-decoder (whisper-base) is contiguous only too (its caches carry
``cross_k``/``cross_v``); like the reference's engine, this one passes no
frames or patches, so a whisper slot cross-attends, in every prefill chunk
and decode step, to the zero rows ``init_caches`` gives it (through the
flash kernel's non-causal form), and a VLM (internvl2-2b) is served from
its token embeddings alone.

The reference compiles four jitted dispatch functions, shared by every
engine of one (cfg, opts, sample); PyTorch runs eagerly, so here they are
plain closures (:func:`dispatch_fns`).  Sampling stays inside them: one
host fetch of the sampled ids per tick.  A paged engine on the card
replays its prefill chunks from CUDA graphs, one per chunk width
(:class:`PrefillGraphs`), and its decode forward from one graph at
B = ``slots`` (:class:`DecodeGraph`), all captured at its first
admission; a contiguous engine, and any engine off the card, runs every
dispatch eagerly.  Each dispatch runs under
:meth:`ServeEngine.observing`: MLA and MoE layers open ``mla`` and ``moe``
spans inside an eager ``decode.forward`` or ``prefill.forward`` (in a
graph only at its capture), and the engine counts the MoE layers' routed
copies and computed expert rows a dispatch from its shapes.  The
simulator's recompile invariant counts the port's first-use builds
(``obs.probes.jit_cache_entries``: kernel libraries, the vision kernels'
shape tables, the attention kernels' ticket buffers, the graphs'
signatures).

On the card, attention runs through the hand-written kernels when
``opts.use_kernels`` is set; inactive slots are mirrored exactly: they keep
advancing ``slot_pos`` and (contiguous) writing their own row, which
``insert_row`` overwrites at the next admission.
"""
from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import EDAConfig, ModelConfig
from repro_torch.core.clock import PREFILL, TOKEN, Clock
from repro_torch.core.engine_core import (INNER, OUTER, BlockPool,
                                          BlockPoolExhausted, EngineCore,
                                          LanePool, PriorityQueue, insert_row)
from repro_torch.core.telemetry import Ledger, SegmentRecord
from repro_torch.device import resolve_device
from repro_torch.events.envelope import DEADLINE_MISS, TOKEN_DONE
from repro_torch.kernels import attention_common as ac
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import observe
from repro_torch.models import transformer as T
from repro_torch.models.attention import DEFAULT_OPTS, RunOpts


@dataclass
class Request:
    rid: str
    tokens: Any                      # (S,) int prompt
    max_new_tokens: int
    priority: int = 1                # 0 = outer/hazard class
    deadline_ms: float = 0.0         # 0 = no deadline (no early stop)
    # stamped by the engine at submit() from the ENGINE's clock
    arrival_s: float = 0.0
    # filled by the engine:
    generated: List[int] = field(default_factory=list)
    prefill_done_s: float = 0.0
    finish_s: float = 0.0
    processing_ms: float = 0.0
    truncated: bool = False
    prompt_truncated: bool = False   # prompt clipped to the cache ring
    # LanePool binding protocol (slot = decode lane while active)
    lane: int = -1
    bound_seq: int = -1

    @property
    def ttft_ms(self) -> float:
        return (self.prefill_done_s - self.arrival_s) * 1000.0

    @property
    def turnaround_ms(self) -> float:
        return (self.finish_s - self.arrival_s) * 1000.0

    @property
    def skip_rate(self) -> float:
        if self.max_new_tokens == 0:
            return 0.0
        return 1.0 - len(self.generated) / self.max_new_tokens


def _argmax_sample(logits: torch.Tensor) -> torch.Tensor:
    """Greedy; ties take the first index, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1)


def dispatch_fns(cfg: ModelConfig, opts: RunOpts, sample: Callable,
                 sink: Optional[int] = None) -> Dict[str, Callable]:
    """The four serving dispatch functions, closing over (cfg, opts,
    sample); each returns sampled token ids, not logits.  ``sink``: the
    paged pool's block that no table names (``ServeEngine.sink``), where
    the paged dispatches that reset nothing send the entries the reference
    drops (``attention.paged_decode_plan``)."""
    def prefill_chunk(params, caches, tokens, positions, start):
        # contiguous: one chunk of a single-row prompt at ring offset start
        logits, caches, _ = T.forward(cfg, params, tokens,
                                      positions=positions, caches=caches,
                                      cache_index=start, opts=opts)
        return sample(logits[0, -1]), caches

    def decode(params, caches, tokens, positions):
        # contiguous: one decode tick for all slots; per-slot ring indices
        logits, caches, _ = T.forward(cfg, params, tokens,
                                      positions=positions[:, None],
                                      caches=caches, cache_index=positions,
                                      opts=opts)
        return sample(logits[:, -1]), caches

    def paged_prefill_chunk(params, caches, tokens, positions, tbl, tlen,
                            reset):
        # paged: the chunk writes into the SHARED pool through this slot's
        # table row (B = 1); reset > 0 on the first chunk invalidates
        # recycled blocks' stale positions.  reset None: the blocks were
        # invalidated beforehand (attention.invalidate_blocks) and every
        # entry lands, a plan with no host sync (the CUDA graphs' form)
        pages = {"tbl": tbl, "len": tlen}
        if reset is None:
            pages["plan"] = attn_mod.paged_decode_plan(
                positions, pages, sink, caches[0]["ppos"].shape[1])
        else:
            pages["reset"] = reset
        logits, caches, _ = T.forward(cfg, params, tokens,
                                      positions=positions, caches=caches,
                                      pages=pages, opts=opts)
        return sample(logits[0, -1]), caches

    def paged_decode(params, caches, tokens, positions, tbl, tlen):
        # paged: all slots through the full block table; retired rows are
        # all -1 (attention fully masked), their entries written into the
        # sink: a plan with no host sync (the decode graph's form)
        pages = {"tbl": tbl, "len": tlen}
        pages["plan"] = attn_mod.paged_decode_plan(
            positions[:, None], pages, sink, caches[0]["ppos"].shape[1])
        logits, caches, _ = T.forward(cfg, params, tokens,
                                      positions=positions[:, None],
                                      caches=caches, pages=pages, opts=opts)
        return sample(logits[:, -1]), caches

    return {"prefill": prefill_chunk, "decode": decode,
            "paged_prefill": paged_prefill_chunk,
            "paged_decode": paged_decode}


#: what the graphs captured in this process were captured for: (cfg,
#: opts, device, pool geometry, chunk width or ``("decode", slots)``), one
#: entry per distinct signature, as the reference's jit caches hold one
#: compile per traced signature (``obs.probes.jit_cache_entries``)
GRAPH_SIGNATURES: set = set()


def _warm_up(eng: "ServeEngine", forwards) -> None:
    """Run each of ``forwards`` once eagerly on a side stream, as a
    capture wants before it: the allocator and the kernels are then warm
    and the capture records no first-use work."""
    main = torch.cuda.current_stream(eng.device)
    side = torch.cuda.Stream(eng.device)
    side.wait_stream(main)
    with torch.cuda.stream(side), eng.observing():
        for f in forwards:
            f()
    main.wait_stream(side)


def _record(eng: "ServeEngine", forward: Callable, pool) -> tuple:
    """Capture ``forward()`` into a CUDA graph of the memory pool
    ``pool``.  Returns (graph, its output, the kernel launches it holds):
    the capture's launches are taken back off ``kernels.ops``' counts, and
    each replay adds them again."""
    before = kops.launches()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, pool=pool), eng.observing():
        out = forward()
    launched = {k: m - before[k] for k, m in kops.launches().items()
                if m != before[k]}
    kops.add_launches({k: -m for k, m in launched.items()})
    return g, out, launched


class _EngineGraphs:
    """What an engine's graphs share: a weak reference to the engine, so
    that an engine and its graphs form no cycle.  A dropped engine then
    frees its graphs at once, by reference counting; left to the cyclic
    garbage collector, they could be destroyed in the middle of another
    engine's capture, which invalidates that capture."""

    def __init__(self, eng: "ServeEngine") -> None:
        self._eng = weakref.ref(eng)

    @property
    def eng(self) -> "ServeEngine":
        return self._eng()


class PrefillGraphs(_EngineGraphs):
    """A paged engine's prefill chunk forward as CUDA graphs, one per chunk
    width (1, 2, 4, ... up to its widest chunk), all captured at once
    (:meth:`capture`, at the engine's first admission) and replayed for
    every chunk after (:meth:`run`).

    Every graph reads one set of static inputs: the chunk's tokens and
    positions (the first ``w`` columns of a (1, widest) pair, copied card
    to card from the uploaded prompt) and the slot's table row and ring
    length (one int32 row, uploaded once an admission by :meth:`begin`).
    Nothing inside a graph waits for the host: RoPE's frequencies are kept
    on the card (``layers.rope_freqs``), the write plan takes every entry
    (``attention.paged_decode_plan``), and :meth:`begin` invalidates the
    slot's recycled blocks before the first replay.  The graphs run the
    eager chunk's kernels (the flash kernel, the decode kernel at width
    1), whose ticket counters are grown to the engine's largest call
    before capture (``attention_common.reserve_counters``)."""

    OWNER = "<prefill graph capture>"

    def __init__(self, eng: "ServeEngine") -> None:
        super().__init__(eng)
        top = min(eng.prefill_chunk, eng.capacity,
                  min(eng.table_cols, eng.num_blocks) * eng.block_size)
        self.widths = [1 << i for i in range(top.bit_length())]
        #: {width: (graph, its sampled token, its kernel launches)}
        self.graphs: Dict[int, tuple] = {}
        #: the graphs' memory pool, which the decode graph shares
        self.pool = None

    def forward(self, w: int) -> torch.Tensor:
        """The chunk forward of width ``w`` on the static inputs, as each
        graph holds it; returns the sampled token."""
        eng, cols = self.eng, self.eng.table_cols
        first, _ = eng._fns["paged_prefill"](
            eng.params, eng.caches, self.tok[:, :w], self.pos[:, :w],
            self.pages[:, :cols], self.pages[0, cols:], None)
        return first

    @torch.no_grad()
    def capture(self) -> None:
        """Warm every width up eagerly on a side stream, then capture each
        into a graph of one shared memory pool.  The chunks write into
        blocks borrowed from the engine's pool and returned after, in the
        order that leaves its free list as it was, so no slot's KV is
        touched."""
        eng = self.eng
        cfg, top = eng.cfg, self.widths[-1]
        blocks = eng.block_pool.alloc(-(-top // eng.block_size), self.OWNER)
        try:
            self.static_inputs(blocks)
            if eng.opts.use_kernels:
                # keyed as the launches key them: by a tensor's device
                ac.reserve_counters(self.pages.device, cfg.num_heads,
                                    cfg.num_kv_heads,
                                    getattr(torch, cfg.compute_dtype),
                                    decode_rows=eng.slots, flash_tokens=top)
            _warm_up(eng, [functools.partial(self.forward, w)
                           for w in self.widths])
            self.pool = torch.cuda.graph_pool_handle()
            for w in self.widths:
                self.graphs[w] = _record(
                    eng, functools.partial(self.forward, w), self.pool)
                GRAPH_SIGNATURES.add(eng.graph_signature(self.pages.device, w))
        finally:
            eng.block_pool.free(blocks[::-1], self.OWNER)
        if eng._moe_dropped is not None:
            # the warm-up chunks' drops are no request's
            eng._moe_dropped.zero_()

    def static_inputs(self, blocks: List[int]) -> None:
        """The graphs' inputs, on the engine's device: tokens and positions
        0.. of the widest chunk, and a table row of ``blocks`` (a ring of
        as many columns)."""
        eng = self.eng
        cols, top = eng.table_cols, self.widths[-1]
        row = np.full((1, cols + 1), -1, np.int32)
        row[0, :len(blocks)] = blocks
        row[0, cols] = len(blocks)
        self.pages = torch.from_numpy(row).to(eng.device)
        self.tok = torch.zeros((1, top), dtype=torch.long, device=eng.device)
        self.pos = torch.arange(top, dtype=torch.int32,
                                device=eng.device)[None]

    def begin(self, slot: int) -> None:
        """An admission's static inputs: the slot's table row and ring
        length (one upload), and its blocks, the row's first ``len``
        columns, invalidated in every layer's pool."""
        eng = self.eng
        n = int(eng._tbl_len[slot])
        self.pages.copy_(torch.from_numpy(
            np.append(eng._tbl[slot], n).astype(np.int32))[None])
        blocks = self.pages[0, :n].long()
        for cache in eng.caches:
            attn_mod.invalidate_blocks(cache, blocks)

    def run(self, tokens: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
        """Replay the graph of the chunk's width on ``tokens`` and
        ``positions`` (1, w), card tensors; returns its sampled token."""
        w = tokens.shape[1]
        self.tok[:, :w].copy_(tokens)
        self.pos[:, :w].copy_(positions)
        g, first, launched = self.graphs[w]
        g.replay()
        kops.add_launches(launched)
        return first


def _aligned(n: int) -> int:
    """``n`` rounded up to a whole 64 bytes of int32."""
    return -(-n // 16) * 16


class DecodeGraph(_EngineGraphs):
    """A paged engine's decode forward (the model step and sampling for all
    ``slots`` rows, ``dispatch_fns(...)["paged_decode"]``) as one CUDA
    graph at B = ``slots``, captured at the engine's first admission after
    the prefill graphs, in their memory pool (:meth:`capture`), and
    replayed every tick after (:meth:`run`).

    The graph reads four static inputs, views of one int32 buffer on the
    card: each slot's last token, its position, its table row and its ring
    length.  :meth:`upload` fills them from the engine's host state with
    one copy of a pinned buffer a tick; the sampled ids' fetch stays
    outside, in the engine.  Nothing inside the graph waits for the host:
    the write plan sends a retired slot's entry into the pool's sink block
    (``attention.paged_decode_plan``), and decode never resets a block,
    since each admission invalidated its own.  The decode kernel's ticket
    counters are those the prefill graphs' capture grew to B = ``slots``
    (``attention_common.reserve_counters``)."""

    def __init__(self, eng: "ServeEngine") -> None:
        super().__init__(eng)
        S, cols = eng.slots, eng.table_cols
        # offsets of tokens, positions, table rows, ring lengths
        self.offsets = [0]
        for n in (S, S, S * cols, S):
            self.offsets.append(self.offsets[-1] + _aligned(n))
        #: (graph, its sampled ids, its kernel launches), once captured
        self.graph: Optional[tuple] = None

    def parts(self, buf) -> tuple:
        """The four inputs in ``buf`` (the card's buffer or the pinned
        one's array): last tokens, positions, table rows (slots, cols),
        ring lengths."""
        S, cols, o = self.eng.slots, self.eng.table_cols, self.offsets
        return (buf[o[0]: o[0] + S], buf[o[1]: o[1] + S],
                buf[o[2]: o[2] + S * cols].reshape(S, cols),
                buf[o[3]: o[3] + S])

    def forward(self) -> torch.Tensor:
        """The decode forward on the static inputs, as the graph holds it;
        returns the sampled ids (slots,)."""
        eng = self.eng
        tok, pos, tbl, tlen = self.parts(self.buf)
        nxt, _ = eng._fns["paged_decode"](
            eng.params, eng.caches, tok.long()[:, None], pos, tbl, tlen)
        return nxt

    @torch.no_grad()
    def capture(self, pool) -> None:
        """Warm the forward up eagerly on a side stream, then capture it
        into a graph of ``pool``.  The static table is all -1 meanwhile, so
        every row's entry lands in the sink and no slot's KV is touched."""
        eng = self.eng
        self.host = torch.empty(self.offsets[-1], dtype=torch.int32,
                                pin_memory=eng.device.type == "cuda")
        self.host_np = self.host.numpy()
        self.host_np[:] = 0
        _, _, tbl, tlen = self.parts(self.host_np)
        tbl[:] = -1
        tlen[:] = 1
        self.buf = self.host.to(eng.device, copy=True)
        _warm_up(eng, [self.forward])
        self.graph = _record(eng, self.forward, pool)
        GRAPH_SIGNATURES.add(eng.graph_signature(self.buf.device,
                                                 ("decode", eng.slots)))
        if eng._moe_dropped is not None:
            # the warm-up's drops are no request's
            eng._moe_dropped.zero_()

    def upload(self) -> None:
        """Fill the static inputs from the engine's host state (last
        tokens, positions, block table, ring lengths): one host-to-card
        copy of the pinned buffer, which no later tick rewrites before the
        card has read it (each tick waits for its sampled ids)."""
        eng = self.eng
        tok, pos, tbl, tlen = self.parts(self.host_np)
        tok[:] = eng.slot_last
        pos[:] = eng.slot_pos
        tbl[:] = eng._tbl
        tlen[:] = eng._tbl_len
        self.buf.copy_(self.host, non_blocking=True)

    def run(self) -> torch.Tensor:
        """Replay the graph on the uploaded inputs; returns its sampled
        ids, a card tensor the next replay overwrites."""
        g, nxt, launched = self.graph
        g.replay()
        kops.add_launches(launched)
        return nxt


class ServeEngine(EngineCore):
    """Continuous-batching token server (chunked-prefill-and-decode shell).

    ``paged``: ``None`` (default) takes the paged block pool wherever the
    arch is eligible, else contiguous rings; ``True`` requires eligibility;
    ``False`` forces contiguous.  ``block_size`` is the KV entries per
    block, ``num_blocks`` the pool size (default: every slot's worst case,
    so admission never backpressures).  ``overflow``: a prompt longer than
    ``cache_capacity - 1`` raises at :meth:`submit` (``"reject"``) or is
    clipped to its last ``cache_capacity - 1`` tokens (``"truncate"``).

    ``params`` are the port's tensors (``transformer.init_params`` or
    ``convert.transformer_from_jax``) on ``device`` — the card unless
    ``device="cpu"``.  Prefill and decode run under ``torch.no_grad()``, so
    parameters that require grad (a model in training) serve as they are:
    the kernels refuse inputs that would need a backward.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 cache_capacity: int = 512, prefill_chunk: int = 128,
                 eda: Optional[EDAConfig] = None,
                 opts: RunOpts = DEFAULT_OPTS,
                 sample: Optional[Callable] = None,
                 name: str = "serve0",
                 ledger: Optional[Ledger] = None,
                 clock: Optional[Clock] = None,
                 overflow: str = "reject",
                 starvation_limit: Optional[int] = 8,
                 paged: Optional[bool] = None,
                 block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 device=None) -> None:
        super().__init__(name, slots=slots, eda=eda, ledger=ledger,
                         clock=clock)
        if overflow not in ("reject", "truncate"):
            raise ValueError(f"overflow must be 'reject' or 'truncate', "
                             f"got {overflow!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.capacity = cache_capacity
        self.prefill_chunk = prefill_chunk
        self.opts = opts
        self.sample = sample or _argmax_sample
        self.overflow = overflow

        if paged is None:
            paged = T.paged_eligible(cfg)
        elif paged and not T.paged_eligible(cfg):
            raise ValueError(
                f"paged=True but arch {cfg.name!r} is not paged-eligible "
                f"(layers {cfg.layer_kinds()}, attention {cfg.attention!r})")
        self.paged = bool(paged)
        self.block_size = block_size
        window = cfg.window if cfg.attention == "sliding" else 0
        if self.paged:
            if window:
                # ring at block granularity: R columns with
                # (R-1)*bs + 1 >= window keep every in-window entry
                ring_cols = -(-(window - 1) // block_size) + 1
            else:
                ring_cols = -(-cache_capacity // block_size)
            self.table_cols = ring_cols
            self.num_blocks = num_blocks or slots * ring_cols
            self.block_pool = BlockPool(self.num_blocks, block_size)
            # one block past the BlockPool's: the sink, which no table
            # names, takes a retired slot's decode entry
            # (``attention.paged_decode_plan``)
            self.sink = self.num_blocks
            self.caches = T.init_paged_caches(cfg, self.sink + 1,
                                              block_size, device=self.device)
            # host-side block table: -1 = unused column; tbl_len is each
            # slot's live ring length in columns
            self._tbl = np.full((slots, self.table_cols), -1, np.int32)
            self._tbl_len = np.ones((slots,), np.int32)
            self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        else:
            self.num_blocks = 0
            self.sink = None
            self.block_pool = None
            self.caches = T.init_caches(cfg, slots, cache_capacity,
                                        device=self.device)
            # a sliding-window arch's ring is clipped to the window: chunks
            # wider than that ring cannot land in one slice write
            self._dense_ring = (min(cache_capacity, window) if window
                                else cache_capacity)
        # decode lanes via the core pool: no preemption — an admitted
        # request's cache row is never evicted mid-decode
        self.pool = LanePool(slots, preempt=False)
        self.slot_pos = np.zeros((slots,), np.int32)
        self.slot_last = np.zeros((slots,), np.int32)
        self.queue = PriorityQueue(starvation_limit=starvation_limit)
        self.finished: List[Request] = []
        self.token_cost_ms = self.unit_cost_ms
        self.tokens_generated = 0
        self._fns = dispatch_fns(cfg, opts, self.sample, self.sink)
        # a paged engine on the card replays its prefill chunks and its
        # decode forward from CUDA graphs, captured at its first admission
        on_card = self.paged and self.device.type == "cuda"
        self._graphs = PrefillGraphs(self) if on_card else None
        self._decode = DecodeGraph(self) if on_card else None
        self.prefill_graph_replays = 0
        self.prefill_eager_chunks = 0
        self.decode_graph_replays = 0
        self.decode_eager_ticks = 0
        # MoE dispatch counts (layers routing through models/moe.py): the
        # copies routed and the expert rows computed, from shapes; the
        # copies dropped, where a capacity applies, on the device
        self._moe_layers = sum(f for _, f in T._layer_sigs(cfg))
        self.moe_routed_copies = self.moe_expert_rows = 0
        self._moe_dropped = (
            torch.zeros((), dtype=torch.int64, device=self.device)
            if self._moe_layers and cfg.moe.capacity_factor is not None
            else None)

    @property
    def active(self) -> List[Optional[Request]]:
        return self.pool.lanes

    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def graph_signature(self, device: torch.device, key) -> tuple:
        """A graph's entry in :data:`GRAPH_SIGNATURES`: this engine's
        (cfg, opts, pool geometry) on ``device``, and ``key`` (a chunk
        width, or ``("decode", slots)``)."""
        return (self.cfg, self.opts, str(device), self.num_blocks,
                self.block_size, self.table_cols, key)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _blocks_needed(self, n_prompt: int, max_new: int) -> int:
        """Table columns a request needs: its logical KV extent, clipped
        to the ring."""
        extent = min(n_prompt + max_new, self.capacity)
        return max(1, min(self.table_cols, -(-extent // self.block_size)))

    def submit(self, req: Request) -> None:
        """Queue a request (hazard class first) and stamp its arrival off
        the engine clock."""
        n_prompt = int(np.shape(req.tokens)[0])
        if n_prompt > self.capacity - 1:
            if self.overflow == "reject":
                raise ValueError(
                    f"request {req.rid!r}: prompt length {n_prompt} "
                    f"exceeds cache_capacity-1 = {self.capacity - 1} — "
                    f"prefill would wrap the ring and corrupt other "
                    f"slots' caches (construct the engine with "
                    f"overflow='truncate' to clip instead)")
            # keep the most recent context
            req.tokens = np.asarray(req.tokens)[-(self.capacity - 1):]
            req.prompt_truncated = True
            n_prompt = self.capacity - 1
        if self.paged:
            need = self._blocks_needed(n_prompt, req.max_new_tokens)
            if need > self.num_blocks:
                raise ValueError(
                    f"request {req.rid!r}: needs {need} KV blocks but the "
                    f"pool only has {self.num_blocks} total (block_size="
                    f"{self.block_size}) — grow num_blocks")
        req.arrival_s = self.clock.now_s()
        self.queue.push(req)

    def _token_budget(self, req: Request) -> int:
        return self.budget(req.deadline_ms, req.max_new_tokens,
                           self.token_cost_ms.get(50.0))

    @torch.no_grad()
    def _prefill_loop(self, slot: int, req: Request) -> int:
        """Chunked prefill in DESCENDING POWER-OF-TWO chunks capped at
        ``prefill_chunk`` and at the ring (e.g. 23 -> 8+8+4+2+1): never any
        padding; an odd prompt ends in a 1-token chunk, which attends
        through the decode kernel.  Returns the sampled first token.

        Phase spans: ``prefill.upload`` (the prompt, its positions and the
        slot's table row or fresh cache row; paged, each chunk's ``reset``
        flag again, or, replayed from graphs, the recycled blocks'
        invalidation once), ``prefill.forward`` per chunk (``tokens`` its
        width, ``graph=1`` where it is a replay), ``prefill.read`` (the
        first token's fetch)."""
        graphs = self._graphs
        with self.tspan("prefill.upload"):
            toks = self._dev(req.tokens, torch.long)[None, :]
            S = int(toks.shape[1])
            pos = torch.arange(S, dtype=torch.int32,
                               device=self.device)[None, :]
            max_chunk = min(self.prefill_chunk, self.capacity)
            if self.paged:
                # a chunk must not exceed the slot's ring (two positions of
                # one scatter mapping to the same pool entry would race)
                max_chunk = min(max_chunk,
                                int(self._tbl_len[slot]) * self.block_size)
                if graphs is not None:
                    graphs.begin(slot)
                else:
                    tbl = self._dev(self._tbl[slot: slot + 1])
                    tlen = self._dev(self._tbl_len[slot: slot + 1])
            else:
                max_chunk = min(max_chunk, self._dense_ring)
                row = T.init_caches(self.cfg, 1, self.capacity,
                                    device=self.device)
        max_chunk = 1 << (max_chunk.bit_length() - 1)
        first = None
        c0 = chunks = 0
        while c0 < S:
            chunk = max_chunk
            while chunk > S - c0:
                chunk //= 2
            if graphs is not None:
                with self.tspan("prefill.forward", tokens=chunk, graph=1):
                    first = graphs.run(toks[:, c0: c0 + chunk],
                                       pos[:, c0: c0 + chunk])
            elif self.paged:
                with self.tspan("prefill.upload"):
                    reset = self._dev([1 if c0 == 0 else 0])
                with self.tspan("prefill.forward", tokens=chunk), \
                        self.observing():
                    first, self.caches = self._fns["paged_prefill"](
                        self.params, self.caches, toks[:, c0: c0 + chunk],
                        pos[:, c0: c0 + chunk], tbl, tlen, reset)
            else:
                with self.tspan("prefill.forward", tokens=chunk), \
                        self.observing():
                    first, row = self._fns["prefill"](
                        self.params, row, toks[:, c0: c0 + chunk],
                        pos[:, c0: c0 + chunk], c0)
            self._count_moe(chunk)
            c0 += chunk
            chunks += 1
        if graphs is not None:
            self.prefill_graph_replays += chunks
            self._count("serve_prefill_graph_replays_total",
                        "prefill chunks replayed from a CUDA graph", chunks)
        else:
            self.prefill_eager_chunks += chunks
            self._count("serve_prefill_eager_chunks_total",
                        "prefill chunks run eagerly", chunks)
        if not self.paged:
            self.caches = insert_row(self.caches, row, slot)
        with self.tspan("prefill.read"):
            return int(first)

    def observing(self):
        """A dispatch's view into the model (``models/observe.py``): the
        ``mla`` and ``moe`` spans on this tick's tracer, the dropped-copy
        counter."""
        return observe.observing(self.tspan, self._moe_dropped)

    def _count_moe(self, rows: int) -> None:
        """Count one forward of ``rows`` tokens through the MoE layers."""
        if not self._moe_layers:
            return
        copies, computed = (n * self._moe_layers for n in
                            moe_mod.dispatch_sizes(self.cfg, rows))
        self.moe_routed_copies += copies
        self.moe_expert_rows += computed
        self._count("serve_moe_routed_copies_total",
                    "token copies routed to experts", copies)
        self._count("serve_moe_expert_rows_total",
                    "expert rows computed (copies and empty slots)", computed)

    def _count(self, name: str, what: str, n: int) -> None:
        """Add ``n`` to this engine's counter ``name`` where metrics are
        attached."""
        if self.metrics is not None:
            self.metrics.counter(name, what, ("engine",)).labels(
                engine=self.name).inc(n)

    def _admit(self, slot: int, req: Request) -> None:
        """Allocate KV (paged: may raise :class:`BlockPoolExhausted` BEFORE
        any compute — the caller backpressures), chunk-prefill, bind.  The
        first admission of a paged engine on the card captures its prefill
        graphs and then its decode graph first, while no slot holds a
        block."""
        S = int(np.shape(req.tokens)[0])
        if self._graphs is not None and not self._graphs.graphs:
            self._graphs.capture()
            self._count("serve_prefill_graphs_total",
                        "prefill chunk widths captured as CUDA graphs",
                        len(self._graphs.graphs))
            if self._decode is not None:
                self._decode.capture(self._graphs.pool)
        if self.paged:
            ncols = self._blocks_needed(S, req.max_new_tokens)
            blocks = self.block_pool.alloc(ncols, req.rid)
            self._slot_blocks[slot] = blocks
            self._tbl[slot, :] = -1
            self._tbl[slot, :ncols] = blocks
            self._tbl_len[slot] = ncols
        t0 = self.clock.now_s()
        with self.tspan("prefill", rid=req.rid, tokens=S, slot=slot):
            first = self._prefill_loop(slot, req)
            self.clock.charge(PREFILL, S)        # no-op on a WallClock
        req.processing_ms += (self.clock.now_s() - t0) * 1000.0

        req.generated.append(first)
        req.prefill_done_s = self.clock.now_s()
        self.pool.bind(req, slot)
        self.slot_pos[slot] = S
        self.slot_last[slot] = first

    # ------------------------------------------------------------------
    # engine loop
    # ------------------------------------------------------------------
    def rebalance(self) -> None:
        """Admission at tick start: free slots take queued requests, hazard
        class first.  Paged: pool exhaustion re-queues the request at the
        front of its class and stops admitting this tick (backpressure)."""
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop()
                try:
                    self._admit(slot, req)
                except BlockPoolExhausted:
                    self.queue.push(req, front=True)
                    break

    def _free_slot_blocks(self, slot: int, rid: str) -> None:
        self.block_pool.free(self._slot_blocks[slot], rid)
        self._slot_blocks[slot] = []
        self._tbl[slot, :] = -1
        self._tbl_len[slot] = 1

    def _retire(self, req: Request) -> None:
        """Close a finished request into the ledger; paged: return its
        blocks to the pool and blank its table row."""
        if self.paged:
            self._free_slot_blocks(req.lane, req.rid)
        req.truncated = len(req.generated) < req.max_new_tokens
        req.finish_s = self.clock.now_s()
        self.finished.append(req)
        self.pool.free(req)
        if self.emitter is not None:
            self.emitter.emit(req.rid, TOKEN_DONE, len(req.generated),
                              emit_s=req.finish_s, trunc=req.truncated)
            if req.truncated:
                self.emitter.emit(req.rid, DEADLINE_MISS,
                                  len(req.generated), emit_s=req.finish_s,
                                  n=req.max_new_tokens - len(req.generated))
        rec = SegmentRecord(
            video_id=req.rid,
            stream=OUTER if req.priority == 0 else INNER,
            device=self.name,
            processing_ms=req.processing_ms,
            # the deadline plays the video-length role
            video_len_ms=req.deadline_ms,
            esd=self.eda.esd,
            frames_total=req.max_new_tokens,
            frames_processed=len(req.generated),
            ttft_ms=req.ttft_ms)
        rec.close(req.turnaround_ms)
        self.ledger.add(rec)
        if self.metrics is not None:
            eng = ("engine",)
            self.metrics.histogram(
                "serve_ttft_ms", "time to first token, retired requests",
                eng).labels(engine=self.name).observe(req.ttft_ms)
            self.metrics.counter(
                "serve_retired_total", "requests retired", eng,
            ).labels(engine=self.name).inc()

    # ------------------------------------------------------------------
    # failover (gateway-driven)
    # ------------------------------------------------------------------
    def evacuate(self) -> List[tuple]:
        """Strip every in-flight and queued request off this replica.
        Active requests lose their prefill (the KV cannot travel): they are
        rewound to submit state and their blocks returned.  Returns
        ``[(request, age_s)]``, actives in slot order then queued in pop
        order."""
        now = self.clock.now_s()
        orphans: List[tuple] = []
        for slot, req in enumerate(list(self.active)):
            if req is None:
                continue
            if self.paged:
                self._free_slot_blocks(slot, req.rid)
            self.pool.free(req)
            req.generated = []
            req.prefill_done_s = 0.0
            req.lane = -1
            req.bound_seq = -1
            orphans.append((req, now - req.arrival_s))
        while self.queue:
            req = self.queue.pop()
            orphans.append((req, now - req.arrival_s))
        return orphans

    def adopt_request(self, req: Request, age_s: float = 0.0) -> None:
        """Accept an evacuated request: a normal ``submit`` with the arrival
        rebased so the wait already served still counts."""
        self.submit(req)
        req.arrival_s = self.clock.now_s() - age_s

    @torch.no_grad()
    def step(self) -> int:
        """One engine tick: admit into free slots, then decode one token
        for every active slot.  Returns tokens generated.

        Phase spans: ``decode`` holds ``decode.upload`` (the slots' last
        tokens, positions and, paged, the block table; into the decode
        graph's inputs, one copy), ``decode.forward`` (the model step and
        sampling as enqueued, ``graph=1`` where it is a replay) and
        ``decode.read`` (the sampled ids' fetch, which waits for the card);
        ``commit`` (the tokens appended, budgets applied, requests
        retired) follows."""
        t0 = self.begin_tick()
        if not any(self.active):
            self.end_tick(t0, 0)
            return 0

        t_d = self.clock.now_s()
        n_active = sum(r is not None for r in self.active)
        graph = self._decode
        with self.tspan("decode", n=n_active):
            if graph is not None and graph.graph is not None:
                with self.tspan("decode.upload"):
                    graph.upload()
                with self.tspan("decode.forward", graph=1):
                    nxt = graph.run()
                self.decode_graph_replays += 1
                self._count("serve_decode_graph_replays_total",
                            "decode ticks replayed from a CUDA graph", 1)
            else:
                with self.tspan("decode.upload"):
                    tokens = self._dev(self.slot_last[:, None], torch.long)
                    positions = self._dev(self.slot_pos)
                    pages = ((self._dev(self._tbl), self._dev(self._tbl_len))
                             if self.paged else ())
                with self.tspan("decode.forward"), self.observing():
                    nxt, self.caches = self._fns[
                        "paged_decode" if self.paged else "decode"](
                        self.params, self.caches, tokens, positions, *pages)
                self.decode_eager_ticks += 1
                self._count("serve_decode_eager_ticks_total",
                            "decode ticks run eagerly", 1)
            self._count_moe(self.slots)
            with self.tspan("decode.read"):
                nxt_host = nxt.cpu().numpy()
            dt = self.finish_dispatch(n_active, t_d, TOKEN)

        with self.tspan("commit"):
            self.slot_pos = self.slot_pos + 1
            self.slot_last = nxt_host.astype(np.int32)
            for slot, req in enumerate(list(self.active)):
                if req is None:
                    continue
                req.generated.append(int(nxt_host[slot]))
                req.processing_ms += dt * 1000.0 / n_active
                budget = self._token_budget(req)
                if len(req.generated) >= min(req.max_new_tokens, budget) \
                        or int(self.slot_pos[slot]) >= self.capacity - 1:
                    self._retire(req)
        self.tokens_generated += n_active
        self.end_tick(t0, n_active)
        return n_active

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    def backlog_units(self) -> int:
        """Queued + in-flight requests (the core pressure signal)."""
        return len(self.queue) + sum(r is not None for r in self.active)

    def stats(self) -> dict:
        """Serving-loop telemetry (mirrors the vision engine's), with the
        port's prefill counts (chunks replayed from graphs, chunks run
        eagerly, the widths captured) and decode counts (ticks replayed
        from the decode graph, ticks run eagerly); with MoE layers, the copies
        routed, the expert rows computed and the copies dropped (0 where
        the config serves dropless; else read from the card, which waits
        for it)."""
        out = {
            "ticks": self.ticks,
            "tokens_generated": self.tokens_generated,
            "busy_s": self.busy_s,
            "token_cost_ms": self.token_cost_ms.get(0.0),
            "tick_cost_ms": self.tick_cost_ms.get(0.0),
            "paged": self.paged,
            "prefill_graph_replays": self.prefill_graph_replays,
            "prefill_eager_chunks": self.prefill_eager_chunks,
            "prefill_graphs": (len(self._graphs.graphs)
                               if self._graphs is not None else 0),
            "decode_graph_replays": self.decode_graph_replays,
            "decode_eager_ticks": self.decode_eager_ticks,
        }
        if self._moe_layers:
            out["moe_routed_copies"] = self.moe_routed_copies
            out["moe_expert_rows"] = self.moe_expert_rows
            out["moe_dropped_copies"] = (0 if self._moe_dropped is None
                                         else int(self._moe_dropped))
        if self.paged:
            out["kv_blocks_used"] = self.block_pool.used_blocks
            out["kv_blocks_free"] = self.block_pool.free_blocks
        return out

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
