"""Port parity: ``transformer.lm_loss`` and its gradients (through
``train.train_step.make_loss_and_grad``, autograd) vs the reference's
``jax.value_and_grad(T.lm_loss)`` (CPU).

Each of the ten registered archs at ``reduced()`` (fp32, 2 rows x 12
tokens of ``lm_batches``, frames or patches where the family takes them)
on the reference's own initial parameters, carried across with
``convert.transformer_from_jax``; the reference's gradient tree goes
through the same map.  Loss: rtol 1e-5.  Gradients: every element within
1e-4 of the reference's global gradient norm (fp32 sums in another order
by the two libraries; the MoE routing is discrete and must agree).  One
bf16 case (starcoder2-3b) at LOOSE 2e-2.  The reference's jitted
gradient runs in the fixture, outside the test's time budget.  Last,
``mxu_bf16`` attention at scores of a trained model's size (|s| up to
~20 over 512 keys): fp32 scores as the reference's, where scores
rounded to bf16 before the softmax would miss by over 10x the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.configs import ASSIGNED
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.config import ParallelConfig, get_arch
from repro_torch.models import attention as TA
from repro_torch.train.train_step import make_loss_and_grad

from torch_train_common import (assert_grads_close, flat, np_batch,
                                port_params, ref_params, torch_batch)

B, S = 2, 12
LOOSE = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(jcfg, np_params, batch):
    def loss_fn(p, b):
        return JT.lm_loss(jcfg, p, b)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        np_params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), float(aux["aux"]), jax.tree.map(np.asarray, grads)


def _case(arch, dtype=None):
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    if dtype:
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype, compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    np_params = ref_params(jcfg)
    batch = np_batch(cfg, B, S)
    loss, aux, grads = _reference(jcfg, np_params, batch)
    return {"cfg": cfg, "params": port_params(cfg, np_params),
            "batch": torch_batch(batch), "loss": loss, "aux": aux,
            "grads": convert.transformer_from_jax(grads, cfg, "cpu")}


@pytest.fixture(params=ASSIGNED)
def fp32_case(request):
    return _case(request.param)


def test_lm_loss_and_grads_match_reference(fp32_case):
    c = fp32_case
    loss, aux, grads = make_loss_and_grad(c["cfg"], ParallelConfig())(
        c["params"], c["batch"])
    np.testing.assert_allclose(float(loss), c["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(aux["aux"]), c["aux"], rtol=1e-5,
                               atol=1e-7)
    assert_grads_close(grads, c["grads"], 1e-4)


def test_lm_loss_and_grads_bf16():
    c = _case("starcoder2-3b", "bfloat16")
    loss, _, grads = make_loss_and_grad(c["cfg"], ParallelConfig())(
        c["params"], c["batch"])
    assert all(g.dtype == torch.bfloat16 for _, g in flat(grads))
    np.testing.assert_allclose(float(loss), c["loss"], rtol=LOOSE)
    assert_grads_close(grads, c["grads"], LOOSE)


def test_mxu_bf16_keeps_fp32_scores():
    """fp32 queries, bf16 K/V, 512 keys, scores of std ~4 (|s| to ~20):
    the output (fp32, as the query) within 1e-5 of the reference's; a bf16
    rounding of the scores before the softmax is more than 10x off."""
    rng = np.random.default_rng(3)
    B, S, C, Hq, Hkv, D = 2, 8, 512, 4, 2, 64
    q = (2.0 * rng.standard_normal((B, S, Hq, D))).astype(np.float32)
    k, v = ((2.0 * rng.standard_normal((B, C, Hkv, D))).astype(np.float32)
            for _ in range(2))
    pos = np.tile(np.arange(C - S, C, dtype=np.int32), (B, 1))
    kv_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    want = np.asarray(JA.dot_attention(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos), jnp.asarray(kv_pos),
        causal=True, opts=JA.RunOpts(mxu_bf16=True)))
    tq = torch.tensor(q)
    tk, tv = (torch.tensor(x).bfloat16() for x in (k, v))
    got = TA.dot_attention(tq, tk, tv, torch.tensor(pos),
                           torch.tensor(kv_pos), causal=True,
                           opts=TA.RunOpts(mxu_bf16=True))
    assert got.dtype == torch.float32
    tol = 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # the same function with the scores rounded to bf16 before the softmax
    qg = tq.reshape(B, S, Hkv, Hq // Hkv, D).bfloat16()
    s = torch.einsum("bskgd,bckd->bskgc", qg, tk).float() / D ** 0.5
    s = s.masked_fill(~(torch.tensor(kv_pos)[:, None, :] <= torch.tensor(
        pos)[:, :, None])[:, :, None, None, :], TA.NEG_INF)
    rounded = torch.einsum("bskgc,bckd->bskgd", torch.softmax(s, -1)
                           .bfloat16().float(), tv.float())
    assert float(s.masked_fill(s < -1e29, 0).abs().max()) > 15
    miss = np.abs(rounded.reshape(B, S, Hq, D).numpy() - want).max()
    assert miss > 10 * tol * (1 + np.abs(want).max())
