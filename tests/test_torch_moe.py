"""Port parity: repro_torch.models.moe (and the MoE stack) vs the
reference (CPU, fp32).

``moe_apply`` runs on the reference's own initialised parameters
(converted with ``repro_torch.convert``) at reduced granite-moe-1b-a400m
(4 experts, top-2, no shared expert) and reduced deepseek-v2-236b (4
experts, top-2, one shared expert).  The routing decisions (top-k ids,
capacity ranks, drops) are integer and must match exactly; real-valued
outputs are held to TIGHT (2e-5): the router, the softmax and the expert
products are fp32 matrix products summed in another order by the two
libraries, and the port's combine sums each token's copies in ascending
expert order where the reference scatter-adds (``models/moe.py``).  The
reference's functions run under ``jax.jit``.  The
stack's logits are held to the same TIGHT; the serving comparison is
exact on tokens and on every timing and ledger field (a ``VirtualClock``
on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import EDAConfig as JEDAConfig
from repro.config import get_arch as jget_arch
from repro.core.clock import VirtualClock as JClock
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.param import init_tree as jinit_tree
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.config import EDAConfig, get_arch
from repro_torch.core.clock import PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.models.layers import apply_mlp
from repro_torch.serving import Request, ServeEngine

TIGHT = dict(rtol=2e-5, atol=2e-5)
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v2-236b"
RATES = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
ENGINE = dict(slots=3, cache_capacity=40, prefill_chunk=8, block_size=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **kw):
    j = dataclasses.replace(jget_arch(arch).reduced(), **kw)
    t = dataclasses.replace(get_arch(arch).reduced(), **kw)
    assert repr(j) == repr(t)
    return j, t


def _moe_params(jc, seed=0):
    jp = jinit_tree(JM.moe_params(jc), jax.random.key(seed), "float32")
    return jp, convert._tensors(_np(jp), torch.device("cpu"))


def _jmoe(jc):
    """The reference's ``moe_apply`` under ``jax.jit`` (its op-by-op first
    call compiles every primitive: seconds per test)."""
    return jax.jit(lambda p, x: JM.moe_apply(jc, p, x))


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TIGHT))


def _routing(cfg, p, x):
    """(expert ids (N, K), copies per expert) of the reference's router."""
    logits = x.reshape(-1, x.shape[-1]) @ np.asarray(p["router"])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    _, eid = jax.lax.top_k(jnp.asarray(probs), cfg.moe.top_k)
    return np.asarray(eid), np.bincount(np.asarray(eid).ravel(),
                                        minlength=cfg.moe.num_experts)


@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
@pytest.mark.parametrize("shape", [(2, 5), (1, 1), (3, 16)],
                         ids=["B2S5", "decode1", "B3S16"])
def test_moe_apply_matches_reference(arch, shape):
    """y and aux at TIGHT on random inputs (decode-sized N = 1 too: the
    capacity floor of 4)."""
    jc, tc = _cfgs(arch)
    jp, tp = _moe_params(jc)
    x = _rand(shape + (jc.d_model,), seed=sum(shape))
    jy, jaux = _jmoe(jc)(jp, jnp.asarray(x))
    ty, taux = TM.moe_apply(tc, tp, torch.as_tensor(x))
    _close(ty, jy)
    _close(taux, jaux)
    assert ty.dtype == torch.float32 and ty.shape == x.shape


def test_moe_forced_drops_match_reference():
    """A router that sends every token to experts 0 and 1: 64 copies each
    against a capacity of 40, so 24 copies of each are dropped (the
    later tokens: the stable sort keeps token order within an expert)."""
    jc, tc = _cfgs(GRANITE)
    jp, tp = _moe_params(jc)
    router = np.array(jp["router"])
    router[:, :2] += 5.0                       # experts 0, 1 dominate
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.as_tensor(router))
    x = np.abs(_rand((4, 16, jc.d_model), seed=3)) + 0.1
    eid, counts = _routing(jc, jp, x)
    N, K, E = 64, jc.moe.top_k, jc.moe.num_experts
    C = max(int(K * N * 1.25 / E), 4)
    assert C == 40 and counts[0] == counts[1] == 64 > C
    jy, jaux = _jmoe(jc)(jp, jnp.asarray(x))
    ty, taux = TM.moe_apply(tc, tp, torch.as_tensor(x))
    _close(ty, jy)
    _close(taux, jaux)
    # tokens past the capacity get no routed output at all (no shared
    # expert in granite): exactly 0, as in the reference
    y = ty.reshape(N, -1)
    assert torch.all(y[C:] == 0) and torch.all(y[:C].abs().sum(-1) > 0)


def test_moe_tied_zero_row_takes_lower_experts():
    """An all-zero row ties every expert (uniform probabilities):
    ``lax.top_k`` takes experts 0..K-1, and the port's stable sort does
    too; the row's output then equals the reference's."""
    jc, tc = _cfgs(DEEPSEEK)
    jp, tp = _moe_params(jc, seed=1)
    x = _rand((2, 4, jc.d_model), seed=5)
    x[0, 1] = 0.0
    x[1, 3] = 0.0
    probs = torch.softmax(torch.zeros(1, jc.moe.num_experts), dim=-1)
    _, idx = TM._top_k(probs, jc.moe.top_k)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), jc.moe.top_k)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[0, 1]]
    jy, jaux = _jmoe(jc)(jp, jnp.asarray(x))
    ty, taux = TM.moe_apply(tc, tp, torch.as_tensor(x))
    _close(ty, jy)
    _close(taux, jaux)
    # ties in random rows too: top-k ids of the port equal lax.top_k's
    r = torch.as_tensor(np.round(_rand((64, 8), seed=6), 1))
    _, idx = TM._top_k(r, 3)
    assert idx.tolist() == np.asarray(
        jax.lax.top_k(jnp.asarray(r.numpy()), 3)[1]).tolist()


def test_moe_shared_expert_is_one_dense_mlp():
    """deepseek's shared expert adds one dense MLP of width n_shared * ff
    to the routed output."""
    jc, tc = _cfgs(DEEPSEEK)
    assert tc.moe.num_shared_experts == 1
    _, tp = _moe_params(jc, seed=2)
    x = torch.as_tensor(_rand((2, 6, tc.d_model), seed=7))
    y, aux = TM.moe_apply(tc, tp, x)
    routed_cfg = dataclasses.replace(
        tc, moe=dataclasses.replace(tc.moe, num_shared_experts=0))
    routed, aux2 = TM.moe_apply(routed_cfg,
                                {k: v for k, v in tp.items()
                                 if k != "shared"}, x)
    assert tp["shared"]["wi"]["w"].shape == (tc.d_model,
                                             tc.moe.expert_ff)
    torch.testing.assert_close(y, routed + apply_mlp(tc, tp["shared"], x),
                               rtol=0, atol=0)
    assert torch.equal(aux, aux2)


@pytest.mark.parametrize("layers", [2, 3])
def test_moe_stack_forward_matches_reference(layers):
    """Reduced granite forward (2 and 3 layers: one stacked segment of
    experts ``(R, E, d, ff)`` unstacked by ``convert``): logits and the
    summed aux at TIGHT; the port's own initialiser gives the reference's
    tree shapes; the layer plan and paged eligibility are the reference's
    at full size.  (deepseek's stack: ``test_torch_mla.py``.)"""
    arch = GRANITE
    jc, tc = _cfgs(arch, num_layers=layers)
    TT.check_supported(get_arch(arch))
    assert TT.plan_layers(get_arch(arch)) == JT.plan_layers(jget_arch(arch))
    assert TT.paged_eligible(get_arch(arch)) == JT.paged_eligible(
        jget_arch(arch))
    jp = JT.init_params(jc, jax.random.key(0))
    tp = convert.transformer_from_jax(_np(jp), tc, device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 11))
    jl, _, jaux = jax.jit(lambda p, t: JT.forward(jc, p, t))(
        jp, jnp.asarray(toks, jnp.int32))
    tl, _, taux = TT.forward(tc, tp, torch.as_tensor(toks))
    _close(tl, jl)
    _close(taux, jaux)
    assert float(taux) > 0
    own = TT.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(tp)


@pytest.fixture(scope="module")
def granite_drained():
    """Reduced granite through the reference's engine and the port's
    (plain and ``use_kernels=True``), paged, under a VirtualClock."""
    jc, tc = _cfgs(GRANITE)
    jp = JT.init_params(jc, jax.random.key(0))
    tp = convert.transformer_from_jax(_np(jp), tc, device="cpu")
    rng = np.random.default_rng(11)
    work = [(f"r{i}", rng.integers(0, 256, n), 6, i % 2)
            for i, n in enumerate((5, 23, 12, 9, 17, 3, 30))]
    out = {}
    j = JServeEngine(jc, jp, paged=True, clock=JClock(rates=RATES),
                     eda=JEDAConfig(), **ENGINE)
    for rid, toks, mx, pr in work:
        j.submit(JRequest(rid=rid, tokens=toks, max_new_tokens=mx,
                          priority=pr))
    out["ref"] = _summary(j, j.run())
    for use_kernels in (False, True):
        t = ServeEngine(tc, tp, paged=True, clock=VirtualClock(RATES),
                        eda=EDAConfig(), device="cpu",
                        opts=RunOpts(use_kernels=use_kernels), **ENGINE)
        for rid, toks, mx, pr in work:
            t.submit(Request(rid=rid, tokens=toks, max_new_tokens=mx,
                             priority=pr))
        out[use_kernels] = _summary(t, t.run())
        t.ledger.check()
        assert t.paged and t.block_pool.used_blocks == 0
    return out


def _summary(eng, done):
    reqs = [(r.rid, list(r.generated), r.ttft_ms, r.turnaround_ms,
             r.truncated) for r in done]
    return reqs, [dataclasses.asdict(r) for r in eng.ledger.records]


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_granite_paged_engine_matches_reference(granite_drained,
                                                use_kernels):
    """Greedy streams, timings and ledger records equal: the port's engine
    hands ``moe_apply`` the reference engine's rows (prefill chunks, every
    decode slot), so the same copies drop."""
    want_reqs, want_recs = granite_drained["ref"]
    got_reqs, got_recs = granite_drained[use_kernels]
    assert len(got_reqs) == 7
    assert [r[:2] for r in got_reqs] == [r[:2] for r in want_reqs]
    assert got_reqs == want_reqs
    assert got_recs == want_recs
