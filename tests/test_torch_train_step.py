"""Port parity: ``repro_torch.train.train_step`` and the training options
of the model (remat, ``block_kv``, ``mxu_bf16``) vs the reference (CPU).

One ``make_train_step`` step (grad_accum 2) from the reference's own
parameters and AdamW state after one reference step (carried across by
``convert.transformer_from_jax`` and ``convert.opt_state_from_jax``):
loss rtol 1e-5, grad norm rtol 1e-4, moments rtol 1e-4 atol 1e-9 (mu)
and 1e-12 (nu), parameters within ``0.05 * lr`` (Adam divides by
sqrt(nu): where a gradient element is near ``eps`` a rounding difference
moves the update by a share of ``lr``).  Then the reference's own
training tests on the port: grad-accum equivalence (xlstm-350m) and loss
falling by 0.5 in 35 steps (starcoder2-3b); remat none/full/dots giving
one gradient; the blocked and bf16-product attentions against the
reference's ``blocked_dot_attention`` and ``dot_attention`` (values and
gradients); training never reaches a cache write; the kernels refusing
inputs that require grad while serving trained parameters works.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JParallelConfig
from repro.config import get_arch as jget_arch
from repro.models import attention as JA
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.config import EDAConfig, ParallelConfig, get_arch
from repro_torch.core.clock import PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.data import lm_batches
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as TA
from repro_torch.models import mla as TMLA
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
from repro_torch.train.train_step import make_loss_and_grad

from torch_train_common import (as_f32, assert_grads_close, clone, flat,
                                np_batch, np_tree, port_params, ref_params,
                                torch_batch)

LR = 1e-3
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_dict(tree):
    return dict(flat(tree))


@pytest.fixture(scope="module")
def ref_two_steps():
    """The reference's state after one step and after two (starcoder2-3b
    reduced, grad_accum 2, 4 x 12 tokens a step)."""
    arch = "starcoder2-3b"
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    params0 = ref_params(jcfg)
    batches = [np_batch(cfg, 4, 12, seed=s) for s in (0, 1)]
    step = jax.jit(jmake_train_step(jcfg, JParallelConfig(grad_accum=2),
                                    JAdamWConfig(**OPT)))
    p1, s1, _ = step(params0, jinit_opt_state(params0),
                     {k: jnp.asarray(v) for k, v in batches[0].items()})
    p1, s1 = np_tree(p1), np_tree(s1)
    p2, s2, m2 = step(p1, s1, {k: jnp.asarray(v)
                               for k, v in batches[1].items()})
    return cfg, (p1, s1), (np_tree(p2), np_tree(s2),
                           {k: float(v) for k, v in m2.items()}), batches[1]


def test_train_step_matches_reference(ref_two_steps):
    cfg, (p1, s1), (p2, s2, m2), batch = ref_two_steps
    params = port_params(cfg, p1)
    state = convert.opt_state_from_jax(s1, cfg, "cpu")
    step = make_train_step(cfg, ParallelConfig(grad_accum=2),
                           AdamWConfig(**OPT))
    params, state, m = step(params, state, torch_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), m2["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), m2["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), m2["lr"], rtol=1e-6)
    assert int(state["step"]) == int(s2["step"]) == 2
    want = convert.opt_state_from_jax(s2, cfg, "cpu")
    for name, atol in (("mu", 1e-9), ("nu", 1e-12)):
        ref = _np_dict(want[name])
        for path, t in flat(state[name]):
            np.testing.assert_allclose(as_f32(t), as_f32(ref[path]),
                                       rtol=1e-4, atol=atol, err_msg=path)
    ref = _np_dict(port_params(cfg, p2))
    old = _np_dict(port_params(cfg, p1))
    moved = 0.0
    for path, t in flat(params):
        np.testing.assert_allclose(as_f32(t), as_f32(ref[path]), rtol=0,
                                   atol=0.05 * LR, err_msg=path)
        moved = max(moved, float(np.abs(as_f32(t) - as_f32(old[path])).max()))
    assert moved > 0.5 * LR


def test_grad_accum_equivalence():
    """accum=4 over one batch == accum=1 (same total batch) up to fp
    error: the reference's ``test_grad_accum_equivalence`` on the port."""
    cfg = get_arch("xlstm-350m").reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    batch = torch_batch(next(lm_batches(8, 16, cfg.vocab_size, steps=1)))
    outs = []
    for accum in (1, 4):
        step = make_train_step(cfg, ParallelConfig(grad_accum=accum), opt)
        p = clone(params)
        p2, _, m = step(p, init_opt_state(p), batch)
        outs.append((p2, float(m["loss"])))
    assert abs(outs[0][1] - outs[1][1]) < 1e-4
    for (_, a), (_, b) in zip(flat(outs[0][0]), flat(outs[1][0])):
        np.testing.assert_allclose(as_f32(a), as_f32(b), rtol=5e-3,
                                   atol=5e-3)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-moe-1b-a400m",
                                  "recurrentgemma-9b"])
def test_remat_policies_give_equal_grads(arch):
    cfg = get_arch(arch).reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = torch_batch(np_batch(cfg, 2, 12))
    out = {}
    for remat in ("none", "full", "dots"):
        loss, _, grads = make_loss_and_grad(
            cfg, ParallelConfig(remat=remat))(params, batch)
        out[remat] = (float(loss), grads)
    for remat in ("full", "dots"):
        assert abs(out[remat][0] - out["none"][0]) <= 1e-6 * abs(out["none"][0])
        assert_grads_close(out[remat][1], out["none"][1], 1e-6)
    with pytest.raises(ValueError):
        make_loss_and_grad(cfg, ParallelConfig(remat="most"))(params, batch)


def _attn_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    B, S, C, Hq, Hkv, D = 2, 16, 16, 4, 2, 8
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, Hq, D), (B, C, Hkv, D), (B, C, Hkv, D)))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kv_pos = pos.copy()
    kv_pos[1, 3] = -1                    # an empty slot
    cot = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    j = [jnp.asarray(x, dtype) for x in (q, k, v)]
    t = [torch.tensor(x).to(getattr(torch, jnp.dtype(dtype).name))
         .requires_grad_() for x in (q, k, v)]
    return j, t, pos, kv_pos, cot


def _ref_attn_grads(fn, j, pos, kv_pos, cot):
    def loss(q, k, v):
        out = fn(q, k, v, jnp.asarray(pos), jnp.asarray(kv_pos))
        return jnp.sum(out.astype(jnp.float32) * cot), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*j)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in grads]


def _port_attn_grads(fn, t, pos, kv_pos, cot):
    out = fn(*t, torch.tensor(pos), torch.tensor(kv_pos))
    grads = torch.autograd.grad((out.float() * torch.tensor(cot)).sum(), t)
    return as_f32(out), [as_f32(g) for g in grads]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6), (False, 0)])
def test_blocked_attention_matches_reference(causal, window):
    j, t, pos, kv_pos, cot = _attn_inputs(jnp.float32)
    want = _ref_attn_grads(
        lambda q, k, v, qp, kp: JA.blocked_dot_attention(
            q, k, v, qp, kp, causal=causal, window=window, block=4),
        j, pos, kv_pos, cot)
    opts = RunOpts(block_kv=4)
    got = _port_attn_grads(
        lambda q, k, v, qp, kp: TA.dot_attention(
            q, k, v, qp, kp, causal=causal, window=window, opts=opts),
        t, pos, kv_pos, cot)
    for g, w in zip([got[0]] + got[1], [want[0]] + want[1]):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
    # and the dense path of both packages agrees with the blocked one
    dense = _port_attn_grads(
        lambda q, k, v, qp, kp: TA.dot_attention(
            q, k, v, qp, kp, causal=causal, window=window), t, pos, kv_pos,
        cot)
    np.testing.assert_allclose(dense[0], got[0], rtol=2e-5, atol=2e-5)


def test_mxu_bf16_attention_matches_reference():
    j, t, pos, kv_pos, cot = _attn_inputs(jnp.bfloat16)
    jopts, topts = JA.RunOpts(mxu_bf16=True), RunOpts(mxu_bf16=True)
    want = _ref_attn_grads(
        lambda q, k, v, qp, kp: JA.dot_attention(
            q, k, v, qp, kp, causal=True, opts=jopts), j, pos, kv_pos, cot)
    got = _port_attn_grads(
        lambda q, k, v, qp, kp: TA.dot_attention(
            q, k, v, qp, kp, causal=True, opts=topts), t, pos, kv_pos, cot)
    for g, w in zip([got[0]] + got[1], [want[0]] + want[1]):
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2)


def test_loss_decreases_end_to_end():
    cfg = get_arch("starcoder2-3b").reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, ParallelConfig(grad_accum=2),
                           AdamWConfig(lr=3e-3, warmup_steps=5,
                                       total_steps=60))
    state = init_opt_state(params)
    losses = []
    for batch in lm_batches(8, 32, cfg.vocab_size, steps=35):
        params, state, m = step(params, state, torch_batch(batch))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-v2-236b",
                                  "whisper-base"])
def test_training_writes_no_cache(arch, monkeypatch):
    """``forward`` in train mode (no caches, no fill) never reaches the
    in-place cache writes, and returns no cache."""
    def refuse(*a, **k):
        raise AssertionError("a cache write in training")
    for mod, name in ((TA, "_write_cache"), (TA, "paged_write"),
                      (TA, "make_filled_cache"), (TMLA, "_write_cache")):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, refuse)
    cfg = get_arch(arch).reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = torch_batch(np_batch(cfg, 2, 8))
    extras = {k: batch[k] for k in ("frames",) if k in batch}
    _, caches, _ = TT.forward(cfg, params, batch["tokens"], extras=extras)
    assert caches is None
    loss, _, grads = make_loss_and_grad(cfg, ParallelConfig(remat="full"))(
        params, batch)
    assert np.isfinite(float(loss))


def test_kernels_refuse_inputs_that_need_grad():
    """The kernels have no backward: under grad mode an input that
    requires grad raises, on the CPU too; under ``no_grad`` they run."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((1, 4, 2, 16)), dtype=torch.float32,
                     requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, 4, 2, 16)), dtype=torch.float32)
    pos = torch.arange(4, dtype=torch.int32)[None]
    opts = RunOpts(use_kernels=True)
    with pytest.raises(RuntimeError, match="no backward"):
        TA.dot_attention(q, k, k, pos, pos, causal=True, opts=opts)
    with pytest.raises(RuntimeError, match="no backward"):
        kops.decode_attention(q[:, :1], k, k, pos[:, :1], pos)
    a = torch.rand(1, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kops.rglru_scan(a, torch.rand(1, 4, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        kops.mlstm_chunkwise(q, k, k, q[..., 0], q[..., 1])
    with torch.no_grad():
        out = TA.dot_attention(q, k, k, pos, pos, causal=True, opts=opts)
    want = TA.dot_attention(q.detach(), k, k, pos, pos, causal=True)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    cfg = get_arch("starcoder2-3b").reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        make_loss_and_grad(cfg, ParallelConfig(use_kernels=True))(
            params, torch_batch(np_batch(cfg, 2, 8)))


def test_serving_parameters_that_require_grad():
    """``ServeEngine`` (kernels on) serves a model in training: its
    parameters require grad, and the drain equals that of detached
    copies."""
    cfg = get_arch("starcoder2-3b").reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rates = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 11, 8)]
    detached = clone(params)
    for _, t in flat(params):
        t.requires_grad_()
    out = []
    for p in (detached, params):
        eng = ServeEngine(cfg, p, slots=2, cache_capacity=32,
                          prefill_chunk=8, clock=VirtualClock(rates),
                          eda=EDAConfig(), device="cpu",
                          opts=RunOpts(use_kernels=True))
        for i, toks in enumerate(prompts):
            eng.submit(Request(rid=f"r{i}", tokens=toks, max_new_tokens=5))
        out.append([(r.rid, list(r.generated), r.turnaround_ms)
                    for r in eng.run()])
    assert all(t.requires_grad for _, t in flat(params))
    assert out[0] == out[1] and all(len(g) == 5 for _, g, _ in out[0])
